"""The port's ``OptionTrainer`` against the JAX package's from
``options/codeformer_stage2.yaml`` and ``options/codeformer_stage3.yaml``,
on the CPU in f32: the checks and tolerances of
``tests/test_torch_option_trainer.py`` (split from it so that each file
stays near 30 s).
"""

import pytest

from test_torch_option_trainer import check_option_file
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", ["codeformer_stage2", "codeformer_stage3"])
def test_option_trainer_matches_jax(name, tmp_path):
    check_option_file(name, tmp_path)
