"""The port's CLIP text tower (``models/clip_text.py``) and its
converters, on the CPU, against the JAX package's ``apply_clip_text`` and
the real ``transformers`` CLIPTextModel.

A tiny tower with each of the four activations the JAX package takes,
with and without a key padding mask, in fp32 at TOL abs against both (the
JAX tests' bound against transformers: the same fp32 arithmetic in other
orders); in bf16 against JAX's bf16 within one bf16 ulp of |ref| plus
TOL_BF16 of max|ref| (the fp32 sums' order, rounded to bf16 at every
layer); the pooled output at EOS, and its per-row fallback for a row
without EOS against the JAX package's; the two converters' equality; a
checkpoint dir; the SD 2.1 manifest (tests/data/clip_sd21_keys.json)
loaded strictly at full width on the meta device.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvvae_tpu.models.clip_text import CLIPTextConfig as JConfig
from cvvae_tpu.models.clip_text import apply_clip_text
from cvvae_tpu.models.clip_text import pooled_output as jpooled
from cvvae_tpu.utils.convert import convert_clip_text_state_dict as jconvert

from cvvae_tpu_torch.models.clip_text import (CLIPText, CLIPTextConfig,
                                              make_text_embedder,
                                              pooled_output)
from cvvae_tpu_torch.utils.convert import (convert_clip_text_state_dict,
                                           from_jax_params,
                                           load_clip_text_checkpoint)

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)

TOL = 2e-5
TOL_BF16 = 2e-2
ACTS = ["gelu", "quick_gelu", "gelu_new", "gelu_pytorch_tanh"]
TINY = dict(vocab_size=99, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=16)
_DATA = os.path.join(os.path.dirname(__file__), "data")


def _tiny(hidden_act):
    torch.manual_seed(0)
    net = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        hidden_act=hidden_act, bos_token_id=97, eos_token_id=98,
        **TINY)).eval()
    port = CLIPText(CLIPTextConfig(hidden_act=hidden_act, **TINY)).eval()
    port.load_state_dict(convert_clip_text_state_dict(net.state_dict()),
                         strict=True)
    return net, port


def _ids(seed, high=99):
    return np.random.RandomState(seed).randint(0, high, (2, 16)).astype(
        np.int64)


def _mask(masked):
    if not masked:
        return None
    mask = np.ones((2, 16), np.int64)
    mask[0, 10:] = 0
    mask[1, 4:] = 0
    return mask


def _maybe(a, fn):
    return None if a is None else fn(a)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hidden_act", ACTS)
def test_clip_text_matches_jax_and_transformers(hidden_act, masked):
    net, port = _tiny(hidden_act)
    ids, mask = _ids(1), _mask(masked)
    with torch.no_grad():
        ref = net(torch.from_numpy(ids), attention_mask=_maybe(
            mask, torch.from_numpy)).last_hidden_state.numpy()
        got = port(torch.from_numpy(ids), _maybe(mask, torch.from_numpy))
    params = jconvert(net.state_dict())
    jref = apply_clip_text(params, jnp.asarray(ids, jnp.int32),
                           JConfig(hidden_act=hidden_act, **TINY),
                           attention_mask=_maybe(mask, jnp.asarray))
    assert got.shape == (2, 16, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_clip_text_bf16_matches_jax(masked):
    """``dtype`` names the compute dtype, as JAX's ``dtype`` argument."""
    net, port = _tiny("gelu")
    ids, mask = _ids(7), _mask(masked)
    got = port(torch.from_numpy(ids), _maybe(mask, torch.from_numpy),
               dtype=torch.bfloat16)
    ref = apply_clip_text(jconvert(net.state_dict()),
                          jnp.asarray(ids, jnp.int32),
                          JConfig(hidden_act="gelu", **TINY),
                          attention_mask=_maybe(mask, jnp.asarray),
                          dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    got, ref = got.float().detach().numpy(), np.asarray(
        ref.astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(got - ref) <= ulp + TOL_BF16 * np.abs(ref).max()).all()


def test_pooled_output_at_eos_and_its_fallback():
    net, port = _tiny("gelu")
    ids = _ids(2, high=98)
    ids[0, 5] = 98
    ids[0, 9] = 98               # the first EOS counts
    ids[1, 11] = 98
    with torch.no_grad():
        ref = net(torch.from_numpy(ids)).pooler_output.numpy()
        hidden = port(torch.from_numpy(ids))
    got = pooled_output(hidden, torch.from_numpy(ids), eos_token_id=98)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    # row 1 without EOS: the per-row argmax fallback, as the JAX package has
    ids[1, 11] = 3
    with torch.no_grad():
        hidden = port(torch.from_numpy(ids))
    got = pooled_output(hidden, torch.from_numpy(ids), eos_token_id=98)
    jref = jpooled(jnp.asarray(hidden.numpy()), jnp.asarray(ids, jnp.int32),
                   eos_token_id=98)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref))
    assert torch.equal(got[1], hidden[1, int(np.argmax(ids[1]))])


def test_converters_agree_and_embedder():
    net, port = _tiny("quick_gelu")
    from_torch = convert_clip_text_state_dict(net.state_dict())
    from_jax = from_jax_params(jax.tree.map(np.asarray,
                                            jconvert(net.state_dict())))
    assert from_jax.keys() == from_torch.keys() == port.state_dict().keys()
    for k, v in from_torch.items():
        assert torch.equal(v, from_jax[k]), k
    ids = torch.from_numpy(_ids(3))
    out = make_text_embedder(port)(ids)
    assert out.dtype == torch.bfloat16 and not out.requires_grad
    with torch.no_grad():
        assert torch.equal(out, port(ids, dtype=torch.bfloat16))
    with pytest.raises(KeyError, match="unrecognised"):
        convert_clip_text_state_dict({"text_model.encoder.layers.0.foo.weight":
                                      torch.zeros(1)})


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_clip_text_checkpoint(tmp_path, fmt):
    from safetensors.torch import save_file

    net, port = _tiny("gelu")
    net.config.save_pretrained(str(tmp_path))
    state = {k: v.contiguous() for k, v in net.state_dict().items()}
    if fmt == "safetensors":
        save_file(state, str(tmp_path / "model.safetensors"))
    else:
        torch.save(state, str(tmp_path / "pytorch_model.bin"))
    loaded = load_clip_text_checkpoint(str(tmp_path), device="cpu")
    assert loaded.config == port.config
    ids = torch.from_numpy(_ids(4))
    with torch.no_grad():
        assert torch.equal(loaded(ids), port(ids))


def test_sd21_manifest_loads_strictly_at_full_width():
    with open(os.path.join(_DATA, "clip_sd21_keys.json")) as f:
        manifest = json.load(f)
    cfg = CLIPTextConfig(**manifest["config"])
    assert cfg == CLIPTextConfig()
    state = {k: torch.empty(s, device="meta")
             for k, s in manifest["keys"].items()}
    converted = convert_clip_text_state_dict(state)
    with torch.device("meta"):
        model = CLIPText(cfg)
    model.load_state_dict(converted, strict=True, assign=True)
    assert len(model.layers) == 23
    assert model.token_embedding.weight.shape == (49408, 1024)
    assert model.layers[0].fc1.weight.shape == (4096, 1024)


def test_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = CLIPTextConfig(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIPText.from_config(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_clip_text_checkpoint(str(tmp_path))
    assert CLIPText.from_config(cfg, device="cpu").token_embedding.weight \
        .device.type == "cpu"


def test_written_transformers_dir_round_trips(tmp_path):
    """chip_smoke's writer (phase 9) lays the port's tower out as
    transformers names it: transformers loads the dir, and so does
    ``load_clip_text_checkpoint``, both agreeing with the source."""
    import chip_smoke

    net, port = _tiny("quick_gelu")
    layout = chip_smoke.clip_reference_layout(port.state_dict())
    expected = {k: v for k, v in net.state_dict().items()
                if not k.endswith("position_ids")}
    assert layout.keys() == expected.keys()
    assert all(torch.equal(v, expected[k]) for k, v in layout.items())
    chip_smoke.write_clip_checkpoint(str(tmp_path), port)
    hf = transformers.CLIPTextModel.from_pretrained(str(tmp_path)).eval()
    loaded = load_clip_text_checkpoint(str(tmp_path), device="cpu")
    ids = torch.from_numpy(_ids(6))
    with torch.no_grad():
        ref = port(ids)
        assert torch.equal(loaded(ids), ref)
        np.testing.assert_allclose(hf(ids).last_hidden_state.numpy(),
                                   ref.numpy(), atol=TOL, rtol=0)
