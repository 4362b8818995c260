"""The port's train step against the JAX package's for the models that run
the SSD kernels: mamba2-1.3b and zamba2-1.2b with the port's ``"kernel"``
impl (K4 forward, K5 backward; their plain versions on the CPU) against the
reference's ``"pallas"`` (interpret mode).  The checks and their
tolerances are those of test_torch_train.py, which states them.
"""
import pytest

from test_torch_train import (  # noqa: F401  (the fixture applies here too)
    _check_first_step_spread, _check_two_steps, _one_torch_thread)

CASES = [("mamba2-1.3b", "kernel", "pallas"), ("zamba2-1.2b", "kernel", "pallas")]


@pytest.mark.parametrize("microbatch", [0, 1])
@pytest.mark.parametrize("arch,impl,jimpl", CASES)
def test_two_train_steps_match_reference(arch, impl, jimpl, microbatch):
    _check_two_steps(arch, impl, jimpl, microbatch)


@pytest.mark.parametrize("arch,impl,jimpl", CASES[:1])
def test_first_step_differs_only_where_the_gradient_is_tiny(arch, impl,
                                                           jimpl):
    _check_first_step_spread(arch, impl, jimpl)
