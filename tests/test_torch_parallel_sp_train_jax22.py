"""The port's dp × sp = 2 × 2 training step on four gloo ranks on the CPU
against the JAX package's step on a (2, 2) CPU mesh, as
``tests/test_torch_parallel_sp_train_jax.py`` holds the sp = 2 step (a
file of its own: each JAX mesh step compiles for ~15 s on the CPU)."""

from tests.test_torch_parallel_sp_train_jax import (check_against_jax,
                                                    port_and_jax)


def test_dp2_sp2_train_step_matches_jax(tmp_path):
    check_against_jax(*port_and_jax(tmp_path, 2, 2))
