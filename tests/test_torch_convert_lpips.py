"""The port's LPIPS converter (``cvvae_tpu_torch/utils/convert_lpips.py``)
against the JAX package's tool (``tools/convert_lpips.py``), on
fabricated state dicts shaped like the real artifacts (torchvision's VGG16
in both its ``features.N.*`` and bare ``N.*`` forms; the reference's
``vgg.pth`` with an extra buffer).

Tolerances: the blobs are compared tensor by tensor (equal); the LPIPS
distance of the port's module loaded from the blob against the JAX
package's metric loaded from the same blob: |d| <= 1e-5 * (1 + |ref|)
(fp32 convs summing in another order).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cvvae_tpu_torch.models import lpips as tlpips
from cvvae_tpu_torch.utils import convert_lpips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_tool(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import importlib
    return importlib.import_module("convert_lpips")


def fabricate(tmp_path, form):
    """(vgg16 path, lin path) of seeded random weights: VGG16 in
    ``form`` ("features": torchvision's full state dict with a classifier
    key; "bare": the features alone), and the five lin heads plus a
    scaling-layer buffer."""
    net = tlpips.init_lpips(torch.Generator().manual_seed(5))
    with torch.no_grad():
        for conv in net.vgg:
            conv.bias.normal_(0.0, 0.1)
    vgg = {}
    for conv, idx in zip(net.vgg, tlpips.VGG_CONV_INDICES):
        vgg[f"{idx}.weight"] = conv.weight.detach().clone()
        vgg[f"{idx}.bias"] = conv.bias.detach().clone()
    if form == "features":
        vgg = {f"features.{k}": v for k, v in vgg.items()}
        vgg["classifier.0.weight"] = torch.zeros(4, 2)
    lins = {f"lin{k}.model.1.weight": lin.weight.detach().clone()
            for k, lin in enumerate(net.lins)}
    lins["scaling_layer.shift"] = torch.zeros(1, 3, 1, 1)
    paths = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth")
    torch.save(vgg, paths[0])
    torch.save(lins, paths[1])
    return paths


@pytest.mark.parametrize("form", ["features", "bare"])
def test_blob_equals_the_jax_tools(tmp_path, jax_tool, form):
    vgg, lin = fabricate(tmp_path, form)
    got = convert_lpips.convert(vgg, lin, str(tmp_path / "port.pth"),
                                check_md5=False)
    ref = jax_tool.convert(vgg, lin, str(tmp_path / "jax.pth"),
                           check_md5=False)
    on_disk = torch.load(str(tmp_path / "port.pth"), weights_only=True)
    for blob in (got, on_disk):
        assert set(blob) == set(ref) == {"vgg", "lins"}
        for part in ref:
            assert list(blob[part]) == list(ref[part])
            for k, v in ref[part].items():
                assert torch.equal(blob[part][k], v), (part, k)


def test_md5_mismatch_warns_and_converts(tmp_path, capsys):
    vgg, lin = fabricate(tmp_path, "features")
    blob = convert_lpips.convert(vgg, lin, str(tmp_path / "blob.pth"))
    err = capsys.readouterr().err
    assert "WARNING" in err and convert_lpips.REFERENCE_LPIPS_MD5 in err
    assert os.path.exists(tmp_path / "blob.pth") and len(blob["lins"]) == 5


@pytest.mark.parametrize("broken", ["vgg", "lin_key", "lin_shape"])
def test_bad_checkpoints_are_refused_as_the_jax_tool_refuses(
        tmp_path, jax_tool, broken):
    vgg, lin = fabricate(tmp_path, "bare")
    if broken == "vgg":
        state = torch.load(vgg, weights_only=True)
        del state["28.bias"]
        torch.save(state, vgg)
    else:
        state = torch.load(lin, weights_only=True)
        if broken == "lin_key":
            del state["lin3.model.1.weight"]
        else:
            state["lin0.model.1.weight"] = torch.zeros(1, 32, 1, 1)
        torch.save(state, lin)
    for tool in (convert_lpips, jax_tool):
        with pytest.raises(SystemExit) as e:
            tool.convert(vgg, lin, str(tmp_path / "x.pth"), check_md5=False)
        assert "missing" in str(e.value) or "shape" in str(e.value)


def test_blob_loads_strict_into_the_ports_lpips(tmp_path, capsys):
    """The CLI writes the blob and loads it ``strict=True`` into the
    port's LPIPS; that module's distance equals the JAX metric loaded from
    the same blob."""
    from cvvae_tpu.models.lpips import load_lpips_params, lpips_distance

    vgg, lin = fabricate(tmp_path, "features")
    out = str(tmp_path / "blob.pth")
    convert_lpips.main(["--vgg16", vgg, "--lpips", lin, "--out", out,
                        "--no-md5-check"])
    assert "verified" in capsys.readouterr().out
    blob = torch.load(out, weights_only=True)
    net = convert_lpips.load_check(blob)
    rs = np.random.RandomState(4)
    a, b = (rs.uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32)
            for _ in range(2))
    with torch.no_grad():
        got = tlpips.lpips_distance(net, torch.from_numpy(a),
                                    torch.from_numpy(b)).numpy()
    ref = np.asarray(lpips_distance(load_lpips_params(blob["vgg"],
                                                      blob["lins"]),
                                    jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= 1e-5 * (1 + np.abs(ref))).all()
