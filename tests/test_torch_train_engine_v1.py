"""One G step and one D step of the port's TrainingEngine against the
JAX package's for the v1 family (4 latent channels) with the SD2.1-named
constraint decoder, constraint "latent", the port's remat on.

Set-up and tolerances: ``tests/torch_train_parity.py`` (losses relative
1e-4; parameter updates within 1e-2 * lr elementwise; lr > 0).
"""

import pytest
import torch

import torch_train_parity as tp

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return tp.Pair("latent", port_remat=True, family="v1")


def test_v1_engine_configs_match(pair):
    assert pair.teng.cfg.family == pair.jeng.cfg.family == "v1"
    assert pair.teng.cfg.constraint_decoder.naming == "sd21"
    assert pair.teng.cfg.latent_channels == pair.jeng.cfg.latent_channels == 4


def test_g_step_metrics_match_jax(pair):
    got, _, _, _ = pair.port_step(2)
    tp.check_metrics(got, pair.metrics[3])
    assert got["scalars/d_weight"] > 0      # the adaptive weight ran


def test_g_step_updates_match_jax(pair):
    _, st, jb, ja = pair.port_step(2)
    lr = pair.teng.lr_schedule_g(2)
    assert lr > 0
    assert tp.check_updates(st, jb, ja, "params", lr) > 0.1
    tp.check_updates(st, jb, ja, "disc_params", lr)   # D unchanged in G


def test_d_step_metrics_match_jax(pair):
    got, _, _, _ = pair.port_step(3)
    tp.check_metrics(got, pair.metrics[4])


def test_d_step_updates_match_jax(pair):
    _, st, jb, ja = pair.port_step(3)
    lr = pair.teng.lr_schedule_d(3)
    assert tp.check_updates(st, jb, ja, "disc_params", lr) > 0.1
    tp.check_updates(st, jb, ja, "params", lr)        # G unchanged in D
