"""The port's data-parallel training (``cvvae_tpu_torch/parallel/data.py``,
``Trainer(mesh=)``, ``train.py`` on ranks) on gloo CPU ranks, each a
spawned process as torchrun starts them (``tests/torch_dp_cases.py``),
against the port's one process on the concatenated batch with the same
draws: the JAX package's DP step is the full-batch step by construction
(``tests/test_parallel.py``), so the port's must equal it.

Tolerances are ``tests/test_parallel.py``'s: every metric relative 1e-4
(there loss/total), parameters atol 1e-5 / rtol 1e-4; after every step
every rank holds the same bits (digest).  bf16 is held to the one
process's own spread under a 2^-9 input change, as
``tests/torch_train_parity.py`` holds the port to JAX's.  Each fixture
spawns its ranks once and runs several cases in them.
"""

import os

import numpy as np
import pytest
import torch

import torch_dp_cases as cases
import torch_train_parity as tp
from cvvae_tpu_torch.parallel import data as dp
from cvvae_tpu_torch.training.engine import named_params
from cvvae_tpu_torch.training.trainer import step_generator

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the 2-rank cases: steps 0 (G, gate closed), 1 (D), 2 (G, the adaptive
#: weight open) with a latent constraint; G and D with an encoder
#: constraint (the noise rows from both halves of [3D; 2D]); a bf16 G step
#: with the gate open from the start; ranks whose batch shapes differ
#: (no clip, so the reduced gradients are the mean of the ranks')
CASES = {
    "latent": {"engine": {"constraint": "latent"},
               "shape": (2, 5, 16, 16, 3), "steps": 3},
    "encoder": {"engine": {"constraint": "encoder"},
                "shape": (2, 5, 16, 16, 3), "steps": 2},
    "bf16": {"engine": {"constraint": "latent", "compute_dtype": "bfloat16",
                        "loss": {"disc_start": 0}},
             "shape": (2, 5, 16, 16, 3), "steps": 1},
    "shapes": {"engine": {"constraint": "latent", "grad_clip": 1e9},
               "shapes": [(2, 1, 16, 16, 3), (1, 5, 16, 16, 3)],
               "steps": 3, "keep_grads": True},
}
CASES_4 = {"latent": dict(CASES["latent"], shape=(4, 5, 16, 16, 3))}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return cases.spawn_ranks(2, tmp_path_factory.mktemp("dp2"),
                             cases.dp_many, CASES)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return cases.spawn_ranks(4, tmp_path_factory.mktemp("dp4"),
                             cases.dp_many, CASES_4)


def test_put_batch_takes_this_ranks_rows():
    mesh = dp.ProcessMesh(1, 2, torch.device("cpu"), "gloo")
    x = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    got = dp.put_batch({"frames": x, "name": "clip"}, mesh)
    assert torch.equal(got["frames"], torch.from_numpy(x[2:]))
    assert got["name"] == "clip"
    assert dp.batch_sharding(mesh).dim == 0
    with pytest.raises(ValueError, match="multiple"):
        dp.put_batch({"frames": x[:3]}, mesh)


def test_process_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        dp.process_mesh("cpu")


@pytest.mark.parametrize("name,k", [("latent", 0), ("latent", 1),
                                    ("latent", 2), ("encoder", 0),
                                    ("encoder", 1)])
def test_dp_step_equals_the_full_batch_step(two, name, k):
    """Step k on two ranks equals the one process's on the concatenated
    batch from the state it started from, with the trainer's draws: G
    with the gate closed, D, G with the adaptive weight open; with an
    encoder constraint G and D."""
    got = two[0][name][k]
    metrics, params = cases.one_process_step(CASES[name], got["start"])
    cases.check_step(got, metrics, params)
    if (name, k) == ("latent", 2):
        assert metrics["scalars/d_weight"] > 0


@pytest.mark.parametrize("k", [0, 1, 2])
def test_four_ranks_equal_the_full_batch_step(four, k):
    got = four[0]["latent"][k]
    cases.check_step(got, *cases.one_process_step(CASES_4["latent"],
                                                  got["start"]))
    assert len({r["latent"][k]["digest"] for r in four}) == 1


def test_ranks_hold_the_same_bits_after_every_step(two):
    for name in CASES:
        for k in range(CASES[name]["steps"]):
            a, b = (r[name][k] for r in two)
            assert a["digest"] == b["digest"], (name, k)
            assert a["metrics"] == b["metrics"], (name, k)
            assert a["grad_norm"] == b["grad_norm"], (name, k)


def test_adaptive_weight_is_taken_of_the_global_losses(two):
    """The weight equals the full batch's, not the one a rank's half alone
    gives (the Lightning reference's per-rank weight)."""
    got = two[0]["latent"][2]
    full = cases.one_process_step(CASES["latent"], got["start"])[0]
    half = cases.one_process_step(CASES["latent"], got["start"],
                                  x=cases.clip(CASES["latent"]["shape"])[:1])[0]
    w = full["scalars/d_weight"]
    assert abs(got["metrics"]["scalars/d_weight"] - w) <= 1e-4 * w
    assert abs(half["scalars/d_weight"] - w) > 1e-2 * w


def test_a_steps_collectives(two):
    """One all-gather of the shapes, the adaptive weight's one reduce
    where the gate is open, the gradients' buckets (fp32, every trainable
    parameter of the stepped net), one reduce of the metrics."""
    eng = cases.engine()
    st = eng.init_state(0)
    sizes = {"g": sum(p.numel() for p in named_params(st.params).values()),
             "d": sum(p.numel() for p in
                      named_params(st.disc_params).values())}
    for k, (kind, adaptive) in enumerate([("g", 0), ("d", 0), ("g", 1)]):
        c = two[0]["latent"][k]["counts"]
        assert c["grad_bytes"] == 4 * sizes[kind]
        assert c["grad_buckets"] == -(-4 * sizes[kind] // dp.BUCKET_BYTES)
        assert c["collectives"] == 1 + adaptive + c["grad_buckets"] + 1
        assert c["seconds"] > 0


def test_bf16_g_step_within_the_one_process_spread(two):
    """A bf16 G step (the adaptive weight open) on two ranks against the
    one process on the concatenated batch, held as the port is held to
    JAX in bf16: each metric within BF16_LOSS_RTOL (+ atol) or twice the
    one process's own distance under a 2^-9 input change, and the update
    within twice that spread's L2 distance."""
    case = CASES["bf16"]
    x = cases.clip(case["shape"])
    got = two[0]["bf16"][0]
    ref, ref_p = cases.one_process_step(case, got["start"])
    spread = []
    for seed in tp.BF16_SPREAD_SEEDS:
        xs = x * (1 + 2.0 ** -9 * np.random.RandomState(seed)
                  .standard_normal(x.shape)).astype(np.float32)
        spread.append(cases.one_process_step(case, got["start"], x=xs))
    tp.check_metrics_bf16(got["metrics"], ref, spread)
    start = cases.snapshot(cases.engine(**case["engine"]).init_state(0))

    def delta(params):
        return torch.cat([(params["params"][k] - start["params"][k])
                          .double().reshape(-1) for k in start["params"]])

    d_ref = delta(ref_p)
    dist = float((delta(got["params"]) - d_ref).norm() / d_ref.norm())
    own = max(float((delta(p) - d_ref).norm() / d_ref.norm())
              for _, p in spread)
    assert dist <= tp.BF16_SPREAD_FACTOR * own, (dist, own)


def test_ranks_whose_shapes_differ_average_their_gradients(two):
    """Rank 0 holds two images, rank 1 a 5-frame clip: each draws from
    its own generator (``rank_generator``), the gradient is the mean of
    the ranks' (no clip here), and the ranks stay identical."""
    got = two[0]["shapes"]
    assert not got[0]["same_shapes"]
    assert all(np.isfinite(v) for r in got for v in r["metrics"].values())
    per_rank = []
    for rank, shape in enumerate(CASES["shapes"]["shapes"]):
        eng = cases.engine(**CASES["shapes"]["engine"])
        eng.keep_grads = True
        st = eng.init_state(0)
        eng.train_step(st, {"frames": torch.from_numpy(
            cases.clip(shape, seed=10 + rank))}, dp.rank_generator(
                step_generator(eng.device, 0, 0), rank))
        per_rank.append(eng.last_grads)
    for k, g in got[0]["grads"].items():
        torch.testing.assert_close(g, (per_rank[0][k] + per_rank[1][k]) / 2,
                                   atol=1e-7, rtol=1e-5)


# ---------------------------------------------------------------------------
# the trainer and train.main
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    runs = [dict(logdir=str(root / "straight"), max_steps=6,
                 trainer_kw=dict(ckpt_every=3)),
            dict(logdir=str(root / "cut"), max_steps=3,
                 trainer_kw=dict(ckpt_every=3)),
            dict(logdir=str(root / "cut"), max_steps=6, resume=True, skip=3,
                 trainer_kw=dict(ckpt_every=3)),
            dict(logdir=str(root / "melk"), max_steps=3, signal_at=(1, 1),
                 trainer_kw=dict(ckpt_every=1000, permanent_every=0))]
    return root, cases.spawn_ranks(2, root, cases.fit_many, runs)


def test_trainer_rank0_alone_writes(fits):
    root, (r0, r1) = fits
    assert r1[0]["files"] is None and r1[1]["files"] is None
    files = r0[0]["files"]
    assert "metrics.csv" in files and "rolling/step_00000006.pt" in files
    rows = open(root / "straight0" / "metrics.csv").read().splitlines()
    assert len(rows) == 1 + 6 + 1       # the header, the steps, validation
    assert [e["kind"] for e in r0[0]["log"]] == list("gdgdgd")


def test_trainer_ranks_stay_identical_and_log_their_reduces(fits):
    _, (r0, r1) = fits
    for a, b in zip(r0, r1):
        assert a["digest"] == b["digest"]
    for e in r0[0]["log"]:
        assert e["reduce"]["grad_bytes"] > 0 and e["reduce"]["seconds"] > 0
        # the shapes, the gradients, the metrics
        assert e["reduce"]["collectives"] >= 3


def test_trainer_resume_on_two_ranks_equals_the_straight_run(fits):
    """Six steps straight equal three, a checkpoint (rank 0's), and three
    more from it broadcast to both ranks, each rank's data resumed."""
    _, (r0, r1) = fits
    straight, resumed = r0[0], r0[2]
    assert resumed["step"] == straight["step"] == 6
    assert resumed["digest"] == straight["digest"]
    assert r1[2]["digest"] == straight["digest"]


def test_trainer_validation_is_the_mean_of_the_ranks(fits):
    _, (r0, r1) = fits
    assert r0[0]["val"] == r1[0]["val"]
    assert all(np.isfinite(v) for v in r0[0]["val"].values())


def test_sigusr1_on_one_rank_checkpoints_on_rank0(fits):
    """Rank 1 is signalled after step 1; the ranks agree on the flag, so
    rank 0 writes the checkpoint of step 2."""
    _, (r0, _) = fits
    assert "rolling/step_00000002.pt" in r0[3]["files"]


def test_a_failing_rank_ends_the_run_on_every_rank(tmp_path):
    """Rank 1's data fails before step 2: rank 0's collective fails too
    (gloo sees its peer gone), well inside the group's timeout, and rank
    0 checkpoints step 2 on the way out."""
    import time
    t0 = time.monotonic()
    out = cases.spawn_ranks(2, tmp_path, cases.fit_many,
                            [dict(logdir=str(tmp_path / "run"), max_steps=6,
                                  fail_at={1: 4})], errors=True)
    assert time.monotonic() - t0 < cases.GROUP_TIMEOUT_S
    assert [k for k, _ in out] == ["error", "error"]
    assert "data source failed" in out[1][1]
    assert os.path.exists(tmp_path / "run0" / "rolling" / "step_00000002.pt")
    assert not os.path.exists(tmp_path / "run1")


def test_train_main_on_two_ranks(tmp_path):
    """``train.main`` on the shipped YAML (tiny widths) in two ranks of a
    group the caller formed: each rank's data sharded by rank (the mixer
    seeded by rank, so shapes may differ), ``--scale_lr`` by world x
    batch, rank 0 alone writing the logdir, the ranks identical; then
    ``--resume`` on both ranks continues from rank 0's checkpoint."""
    import chip_smoke
    from cvvae_tpu_torch.training.checkpoint import CheckpointManager
    tar_dir, csv_dir, video_root = chip_smoke.write_train_data(
        str(tmp_path / "data"), seed=3, n_images=6, image_hw=(40, 48),
        n_videos=2, video_frames=12, video_hw=(40, 48))
    e = "model.engine.params."
    logdir = str(tmp_path / "run")
    argv = ["--base", os.path.join(ROOT, "configs",
                                   "sd3_latent_constraint.yaml"),
            "--train", "--device", "cpu", "--logdir", logdir, "--scale_lr",
            f"{e}net.params.block_out_channels=[8,8,8,8]",
            f"{e}net.params.layers_per_block=1",
            f"{e}net.params.norm_num_groups=4",
            f"{e}disc.params.ndf=8", f"{e}disc.params.n_layers=2",
            f"{e}disc.params.norm_groups=4",
            f"{e}constraint_decoder.params.block_out_channels=[8,8,8,8]",
            f"{e}constraint_decoder.params.layers_per_block=1",
            f"{e}constraint_decoder.params.norm_num_groups=4",
            f"{e}loss.params.perceptual_weight=0.0", f"{e}remat=false",
            f"data.train.datasets.image_webdata.urls_or_dir={tar_dir}",
            "data.train.datasets.image_webdata.batch_size=1",
            "data.train.datasets.image_webdata.decoder.params.size=32",
            f"data.train.datasets.webvid.urls_or_dir={csv_dir}",
            "data.train.datasets.webvid.decoder.params.num_frames=5",
            "data.train.datasets.webvid.decoder.params.resize=40",
            "data.train.datasets.webvid.decoder.params.crop_size=32",
            f"data.train.datasets.webvid.decoder.params.video_root="
            f"{video_root}",
            "trainer.ckpt_every=2", "trainer.image_every=0"]
    (a, a2), (b, b2) = cases.spawn_ranks(
        2, tmp_path, cases.train_main_rank,
        [argv + ["--max_steps", "4"],
         argv + ["--max_steps", "6", "--resume"]])
    assert a["is_writer"] and not b["is_writer"]
    assert a["step"] == b["step"] == 4 and a["digest"] == b["digest"]
    assert a["base_lr"] == b["base_lr"] == pytest.approx(2 * 1 * 2e-5)
    shapes = {s for r in (a, b) for _, s, _ in r["log"]}
    assert shapes <= {(1, 1, 32, 32, 3), (1, 5, 32, 32, 3)}
    assert all(c["grad_bytes"] > 0 for r in (a, b) for _, _, c in r["log"])
    # rank 0's rows alone (a run's logger rewrites the file: the resumed
    # run's steps)
    rows = open(os.path.join(logdir, "metrics.csv")).read().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["5", "6"]
    assert a2["step"] == b2["step"] == 6 and a2["digest"] == b2["digest"]
    ckpt = CheckpointManager(logdir)
    assert ckpt.latest_step() == 6
    blob = torch.load(tmp_path / "run" / "rolling" / "step_00000006.pt",
                      weights_only=True)
    assert all(torch.equal(blob["params"][k], v)
               for k, v in a2["params"]["params"].items())
