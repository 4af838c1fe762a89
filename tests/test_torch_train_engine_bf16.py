"""One G step and one D step of the port's TrainingEngine against the
JAX package's in its bf16 mode (``compute_dtype="bfloat16"``: fp32
parameters, optimizer and EMA, bf16 compute), constraint "latent", with
LPIPS on and the port's remat on.

Set-up and tolerances: ``tests/torch_train_parity.py`` (metrics within
2e-2 relative + 1e-3, or within twice JAX's own distance from itself
under a 2^-9 change of the input, whichever is larger; the updates
together within twice JAX's own L2 distance from itself); every
parameter and AdamW moment fp32 after each step.
"""

import pytest
import torch

import torch_train_parity as tp

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return tp.Pair("latent", perceptual=0.5, port_remat=True,
                   compute_dtype="bfloat16")


def _all_fp32(st):
    leaves = (list(st.params.parameters())
              + list(st.disc_params.parameters())
              + [v for o in (st.opt_g, st.opt_d)
                 for v in list(o.mu.values()) + list(o.nu.values())])
    return {t.dtype for t in leaves} == {torch.float32}


def test_g_step_metrics_match_jax(pair):
    got, st, _, _ = pair.port_step(2)
    tp.check_metrics_bf16(got, pair.metrics[3], pair.spread(2))
    assert got["scalars/d_weight"] > 0      # the adaptive weight ran
    assert _all_fp32(st)


def test_g_step_updates_match_jax(pair):
    _, st, jb, ja = pair.port_step(2)
    assert pair.teng.lr_schedule_g(2) > 0
    assert tp.check_updates_bf16(st, jb, ja, "params", pair.spread(2)) > 0
    assert tp.check_updates_bf16(st, jb, ja, "disc_params",
                                 pair.spread(2)) == 0


def test_d_step_metrics_match_jax(pair):
    got, st, _, _ = pair.port_step(3)
    tp.check_metrics_bf16(got, pair.metrics[4], pair.spread(3))
    assert _all_fp32(st)


def test_d_step_updates_match_jax(pair):
    _, st, jb, ja = pair.port_step(3)
    assert tp.check_updates_bf16(st, jb, ja, "disc_params",
                                 pair.spread(3)) > 0
    assert tp.check_updates_bf16(st, jb, ja, "params", pair.spread(3)) == 0
