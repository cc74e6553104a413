"""`envs.core.env_step` against the JAX package's per-env step on the
tasks of part 3 of 5 (see test_torch_env_step_a.py for the cases and the
tolerances)."""

import pytest

from tests.test_torch_env_step_a import check_env_step, tasks


@pytest.mark.parametrize("name", tasks(3))
def test_env_step_matches_jax(name):
    check_env_step(name)
