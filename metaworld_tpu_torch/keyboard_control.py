"""Human teleoperation of a single env from the terminal (the reference's
scripts/keyboard_control.py, without an OpenGL window).

Counterpart of `scripts/keyboard_control.py` over the port's `SawyerEnv`
(the kernel at N = 1 on a CUDA device).

    python -m metaworld_tpu_torch.keyboard_control --env drawer-open-v3
    printf 'wwdq x' | python -m metaworld_tpu_torch.keyboard_control --device cpu

Keys: w/s = +/-y, a/d = -/+x, q/e = +/-z, space = toggle gripper,
r = reset, x = quit. Each keypress steps the env a few times and prints the
live obs/reward line; pass --save-frames DIR to also dump rgb frames from
the host-side rasterizer. Piped input is read one character at a time, and
its end quits.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

KEYMAP = {
    "w": (0.0, 1.0, 0.0), "s": (0.0, -1.0, 0.0),
    "a": (-1.0, 0.0, 0.0), "d": (1.0, 0.0, 0.0),
    "q": (0.0, 0.0, 1.0), "e": (0.0, 0.0, -1.0),
}


def getch() -> str:
    """One key from stdin: raw mode on a terminal, one character from
    piped input ("x" at its end)."""
    stream = sys.stdin
    if not stream.isatty():
        ch = stream.read(1)
        return ch if ch else "x"
    import termios
    import tty

    fd = stream.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        return stream.read(1)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="reach-v3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=5,
                    help="env steps per keypress")
    ap.add_argument("--save-frames", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import metaworld_tpu_torch as mw

    env = mw.SawyerEnv(args.env, seed=args.seed, render_mode="rgb_array",
                       device=args.device)
    env.set_task(mw.MT1(args.env, seed=args.seed).train_tasks[0])
    obs, _ = env.reset()
    grip, t = -1.0, 0
    print(__doc__)
    while True:
        ch = getch()
        if ch in ("x", "\x03"):
            break
        if ch == "r":
            obs, _ = env.reset()
            t = 0
            print("reset")
            continue
        if ch == " ":
            grip = -grip
        move = KEYMAP.get(ch, (0.0, 0.0, 0.0))
        for _ in range(args.repeat):
            obs, r, term, trunc, info = env.step(np.array([*move, grip]))
            t += 1
        print(f"t={t:4d} hand={np.round(obs[:3], 3)} obj={np.round(obs[4:7], 3)} "
              f"r={r:7.3f} success={int(info['success'])}", flush=True)
        if args.save_frames:
            os.makedirs(args.save_frames, exist_ok=True)
            frame = env.render()
            np.save(os.path.join(args.save_frames, f"frame_{t:05d}.npy"), frame)
        if info["success"]:
            print("*** SUCCESS ***")


if __name__ == "__main__":
    main()
