"""Render scripted-policy rollout movies (GIF) for any task and camera.

Counterpart of `scripts/policy_movies.py` (the reference's
scripts/scripted_policy_movies.ipynb): steps the env with its scripted
expert through `envs.core.env_step` at n = 1 on the device, renders every
k-th frame on the host through `render.render_camera`, and writes an
animated GIF with PIL (imported by `write_gif` only). Optional gaussian
action noise as a fraction of the action range, the notebook's
`act_noise_pct`.

    python -m metaworld_tpu_torch.policy_movies --env door-open-v3 --camera corner
    python -m metaworld_tpu_torch.policy_movies --env pick-place-v3 \\
        --camera gripperPOV --noise 0.1 --out /tmp/movies --width 320 --height 240
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from metaworld_tpu_torch import benchmarks
from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import env_reset, env_step
from metaworld_tpu_torch.policies import get_policy
from metaworld_tpu_torch.render import render_camera


def rollout_frames(name, camera, width, height, noise_pct, seed, goal, every,
                   quit_on_success=True, max_steps=500, device="cuda"):
    """(frames, steps run): the expert from goal row `goal` of
    `MT1(name, seed)`, a frame every `every` steps and one at the first
    success (where the rollout stops unless `quit_on_success` is off)."""
    dev = torch.device(device)
    spec = registry.get_spec(name)
    tbl = benchmarks.MT1(name, seed=seed, num_goals=goal + 1).goal_table(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state, obs = env_reset(
        spec, torch.tensor(tbl[goal:goal + 1], dtype=torch.float32, device=dev),
        1.0, gen)
    pol = get_policy(name)
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(max_steps):
        a = pol(obs)
        if noise_pct > 0:  # the action range is [-1, 1]
            a = torch.from_numpy(rng.normal(a.cpu().numpy(), noise_pct * 2.0)
                                 .astype(np.float32)).to(dev)
        state, out = env_step(spec, state, a)
        obs = out.obs
        if t % every == 0:
            frames.append(render_camera(spec, state, camera=camera, width=width,
                                        height=height).astype(np.uint8))
        if quit_on_success and float(out.success[0]) > 0:
            frames.append(render_camera(spec, state, camera=camera, width=width,
                                        height=height).astype(np.uint8))
            break
    return frames, t + 1


def write_gif(frames, path, fps):
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="pick-place-v3")
    ap.add_argument("--camera", default="corner",
                    help="topview/corner/corner2/corner3/corner4/"
                         "behindGripper/gripperPOV")
    ap.add_argument("--width", type=int, default=240)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="action noise as fraction of the action range")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--goal", type=int, default=0)
    ap.add_argument("--every", type=int, default=4,
                    help="render every k-th control step")
    ap.add_argument("--fps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "mw_movies"))
    ap.add_argument("--all", action="store_true",
                    help="render every one of the 50 tasks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    names = registry.ALL_V3_ENVIRONMENTS if args.all else [args.env]
    for name in names:
        frames, steps = rollout_frames(
            name, args.camera, args.width, args.height, args.noise, args.seed,
            args.goal, args.every, device=args.device)
        path = os.path.join(args.out, f"{name}-{args.camera}.gif")
        write_gif(frames, path, args.fps)
        print(f"{name}: {steps} steps, {len(frames)} frames -> {path}",
              flush=True)


if __name__ == "__main__":
    main()
