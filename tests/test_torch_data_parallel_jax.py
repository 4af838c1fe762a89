"""The port's data-parallel step on two gloo CPU ranks against the JAX
package's full-batch ``train_step`` (which its own DP step equals by
construction, ``shard_parallel_step``): a G step with the adaptive weight
open and a D step, constraint "latent", on a clip of two, each rank from
the JAX state before the step with its rows of JAX's draws (the
posterior's noise split by rows, the constraint offsets shared).

Set-up and tolerances: ``tests/torch_train_parity.py`` (losses relative
1e-4; updates within 1e-2 * lr elementwise); one JAX compile.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dp_cases as cases
import torch_train_parity as tp
from cvvae_tpu_torch.utils.convert import from_jax_train_state

torch.set_num_threads(2)

CLIP = (2, 5, 16, 16, 3)


@pytest.fixture(scope="module")
def pair():
    return tp.Pair("latent", clip=CLIP)


@pytest.fixture(scope="module")
def ranks(pair, tmp_path_factory):
    """Steps 2 (G) and 3 (D) on two ranks, each from JAX's state before
    it; each rank's [(metrics, state dict after, digest)]."""
    starts = [(from_jax_train_state(jax.tree.map(np.asarray,
                                                 pair.states[k])),
               pair.draws(k)) for k in (2, 3)]
    frozen = {k: v.state_dict() for k, v in pair.teng.frozen.items()
              if v is not None}
    return cases.spawn_ranks(2, tmp_path_factory.mktemp("dpjax"),
                             cases.from_states, pair.teng.cfg, frozen,
                             pair.x, starts)


def _state(pair, blob):
    return pair.teng.init_state(0).load_state_dict(blob)


def test_dp_g_step_metrics_match_jax_full_batch(pair, ranks):
    got = ranks[0][0][0]
    tp.check_metrics(got, pair.metrics[3])
    assert got["scalars/d_weight"] > 0      # the adaptive weight ran


def test_dp_g_step_updates_match_jax_full_batch(pair, ranks):
    st = _state(pair, ranks[0][0][1])
    jb, ja = pair.states[2], pair.states[3]
    lr = pair.teng.lr_schedule_g(2)
    assert tp.check_updates(st, jb, ja, "params", lr) > 0.1
    tp.check_updates(st, jb, ja, "disc_params", lr)


def test_dp_d_step_metrics_match_jax_full_batch(pair, ranks):
    tp.check_metrics(ranks[0][1][0], pair.metrics[4])


def test_dp_d_step_updates_match_jax_full_batch(pair, ranks):
    st = _state(pair, ranks[0][1][1])
    jb, ja = pair.states[3], pair.states[4]
    lr = pair.teng.lr_schedule_d(3)
    assert tp.check_updates(st, jb, ja, "disc_params", lr) > 0.1
    tp.check_updates(st, jb, ja, "params", lr)


def test_dp_ranks_hold_the_same_bits(ranks):
    for k in range(2):
        assert ranks[0][k][2] == ranks[1][k][2]
        assert ranks[0][k][0] == ranks[1][k][0]
