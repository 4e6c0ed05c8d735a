"""The port's checkpoint path (tensorlink_tpu_torch/models/registry.py,
engine/loader.py, engine/safetensors_io.py) against the JAX package and
``transformers`` on tiny local checkpoints of all ten families
(tests/test_models_parity.py's ``FAMILIES``/``_make_checkpoint``):

- ``config_from_hf`` equals JAX's field for field, ``to_json`` equals
  JAX's, and ``from_json`` moves a config either way;
- ``load_params`` leaves are byte-equal to ``params_from_jax`` of the JAX
  loader's tree, in float32 and in bfloat16 cast from the float32
  checkpoint (round to nearest even in both);
- the port's ``forward`` matches the ``transformers`` logits (atol 5e-3,
  mean error under 5e-4, as the JAX test holds the JAX forward);
- ``export_hf`` writes files byte-equal to JAX's ``export_hf`` (single
  file in float32, sharded in bfloat16), and the JAX loader reads the
  port's export back to the same tree;
- the hub path over ``TLTPU_HUB_SOURCE`` (tests/test_hub.py's cases), the
  longrope and unknown-``model_type`` refusals, ``param_count`` against
  JAX's for every preset, and the safetensors writer byte-equal to
  ``safetensors.numpy.save_file`` and read back by ``safe_open``.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_models_parity import FAMILIES, _make_checkpoint

from tensorlink_tpu.engine import loader as jloader
from tensorlink_tpu.models import registry as jregistry
from tensorlink_tpu.models.base import ModelConfig as JModelConfig
from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.engine import loader as tloader
from tensorlink_tpu_torch.engine import safetensors_io as sio
from tensorlink_tpu_torch.models import forward
from tensorlink_tpu_torch.models import registry as tregistry
from tensorlink_tpu_torch.models.base import ModelConfig

# one intra-op thread: a JAX call in this process can leave torch's worker
# threads computing exp off by up to 1e-4 (tests/test_torch_flash.py)
torch.set_num_threads(1)

# tlint: disable=TL006(read-only constant table)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
HUB_REPO = "test-org/tiny-llama"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """``checkpoint(family)`` → ``(hf_model, hf_cfg, ckpt_dir)``, built
    once per module and family."""
    made = {}

    def get(family):
        if family not in made:
            made[family] = _make_checkpoint(
                family, tmp_path_factory.mktemp(family))
        return made[family]

    return get


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes (bfloat16 through its 16-bit payload)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _assert_trees_bitwise(got: dict, want: dict):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for name in w:
        assert g[name].dtype == w[name].dtype, name
        assert g[name].shape == w[name].shape, name
        assert np.array_equal(_bits(g[name]), _bits(w[name])), name


def _dir_bytes(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# -- the registry --------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_from_hf_and_json_equal_jax(family, checkpoint):
    _, hf_cfg, _ = checkpoint(family)
    jcfg = jregistry.config_from_hf(hf_cfg)
    cfg = tregistry.config_from_hf(hf_cfg)  # an object with to_dict
    assert cfg == tregistry.config_from_hf(hf_cfg.to_dict())
    assert cfg.dtype == torch.bfloat16 and cfg.family == family
    for f in dataclasses.fields(JModelConfig):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.to_json() == jcfg.to_json()
    assert json.dumps(cfg.to_json()) == json.dumps(jcfg.to_json())
    assert ModelConfig.from_json(jcfg.to_json()) == cfg
    assert JModelConfig.from_json(cfg.to_json()) == jcfg
    f32 = tregistry.config_from_hf(hf_cfg, dtype=torch.float32)
    assert f32.to_json() == jregistry.config_from_hf(
        hf_cfg, dtype=jnp.float32).to_json()
    assert tregistry.hf_prefix(cfg) == jregistry.hf_prefix(jcfg)
    assert tregistry.hf_name_map(cfg) == jregistry.hf_name_map(jcfg)


def test_registry_refusals():
    with pytest.raises(ValueError, match="unsupported model_type"):
        tregistry.config_from_hf({"model_type": "bert"})
    phi3 = dict(FAMILIES["phi3"]["cfg"],
                rope_scaling={"type": "longrope", "short_factor": [1.0]})
    with pytest.raises(ValueError, match="longrope"):
        tregistry.config_from_hf(phi3)
    with pytest.raises(ValueError, match="longrope"):
        jregistry.config_from_hf(phi3)
    with pytest.raises(TypeError, match="dtype"):
        ModelConfig.from_json(dict(ModelConfig().to_json(), dtype="float8"))


@pytest.mark.parametrize("name", sorted(jregistry.config_presets()))
def test_presets_param_count_and_json_equal_jax(name):
    jcfg = jregistry.config_presets()[name]
    cfg = tregistry.config_presets()[name]
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.to_json() == jcfg.to_json()
    assert tloader.estimate_params_bytes(cfg) == \
        jloader.estimate_params_bytes(jcfg)


# -- loading -------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_load_params_byte_equal_jax(family, dtype, checkpoint):
    _, _, ckpt = checkpoint(family)
    jdt, tdt = DTYPES[dtype]
    jcfg, jparams = jloader.load_params(ckpt, dtype=jdt)
    cfg, params = tloader.load_params(ckpt, dtype=tdt, device="cpu")
    assert cfg.to_json() == jcfg.to_json()
    assert cfg.dtype == tdt
    _assert_trees_bitwise(params,
                          params_from_jax(jax.device_get(jparams),
                                          device="cpu"))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_matches_transformers(family, checkpoint):
    model, _, ckpt = checkpoint(family)
    cfg, params = tloader.load_params(ckpt, dtype=torch.float32,
                                      device="cpu")
    assert cfg.family == family
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 100, size=(2, 12)).astype(np.int64)
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(tokens)).logits.numpy()
        got, _ = forward(params, torch.from_numpy(tokens), cfg)
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3)
    assert np.abs(got - ref).mean() < 5e-4


# -- export ----------------------------------------------------------------
@pytest.mark.parametrize("dtype,shard_bytes", [("float32", 4 * 1024**3),
                                               ("bfloat16", 20_000)],
                         ids=["single-f32", "sharded-bf16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_export_byte_equal_jax(family, dtype, shard_bytes, checkpoint,
                               tmp_path):
    _, hf_cfg, ckpt = checkpoint(family)
    jdt, tdt = DTYPES[dtype]
    jcfg, jparams = jloader.load_params(ckpt, dtype=jdt)
    cfg, params = tloader.load_params(ckpt, dtype=tdt, device="cpu")
    hf = hf_cfg.to_dict()
    jout = jloader.export_hf(jcfg, jparams, tmp_path / "jax", hf_config=hf,
                             max_shard_bytes=shard_bytes)
    tout = tloader.export_hf(cfg, params, tmp_path / "port", hf_config=hf,
                             max_shard_bytes=shard_bytes)
    want, got = _dir_bytes(jout), _dir_bytes(tout)
    assert sorted(got) == sorted(want)
    assert ("model.safetensors.index.json" in got) == (shard_bytes < 10**6)
    for name in want:
        assert got[name] == want[name], name
    # the JAX loader reads the port's export back to the JAX tree
    _, back = jloader.load_params(tout, dtype=jdt)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(jparams)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def test_load_options_and_errors(checkpoint, tmp_path):
    _, _, ckpt = checkpoint("llama")
    cfg, full = tloader.load_params(ckpt, dtype=torch.float32, device="cpu")
    # layer_range on a local directory: the slice of the full tree
    _, part = tloader.load_params(ckpt, cfg, layer_range=(1, 2),
                                  dtype=torch.float32, device="cpu")
    want = _leaves(full["layers"])
    for name, leaf in _leaves(part["layers"]).items():
        assert torch.equal(leaf, want[name][1:2]), name
    # onto tensor-parallel shards (tests/test_torch_tp.py): the local
    # cards unless the devices are named, never fewer
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="mesh needs 2 devices"):
            tloader.load_params(ckpt, tensor_parallel=2, device="cpu")
    _, placed = tloader.load_params(ckpt, cfg, tensor_parallel=2,
                                    tp_devices=["cpu", "cpu"])
    wq = placed["layers"]["attn"]["wq"]
    assert torch.equal(wq.full(), full["layers"]["attn"]["wq"])
    assert [t.shape[-1] for t in wq.shards] == \
        [full["layers"]["attn"]["wq"].shape[-1] // 2] * 2
    with pytest.raises(KeyError, match="not in checkpoint"):
        tloader.load_params(ckpt, cfg.with_(n_layers=3), device="cpu")
    with pytest.raises(FileNotFoundError):
        tloader.CheckpointReader(tmp_path)
    from tensorlink_tpu_torch.models.quant import quantize_params

    q = quantize_params(full, min_size=1)
    with pytest.raises(TypeError, match="quantized"):
        tloader.export_hf(cfg, q, tmp_path / "q")


# -- the safetensors format ----------------------------------------------
def _arrays(rng):
    return {
        "model.layers.0.w": rng.normal(size=(3, 5)).astype(np.float32),
        "b": rng.normal(size=(4,)).astype(ml_dtypes.bfloat16),
        "a.f16": rng.normal(size=(2, 2)).astype(np.float16),
        "f64": rng.normal(size=(3,)),
        "i64": rng.integers(-9, 9, size=(2,)),
        "i32": rng.integers(-9, 9, size=(5,)).astype(np.int32),
        "i16": rng.integers(-9, 9, size=(3,)).astype(np.int16),
        "i8": rng.integers(-9, 9, size=(7,)).astype(np.int8),
        "u8": rng.integers(0, 255, size=(1, 3)).astype(np.uint8),
        "mask": rng.integers(0, 2, size=(3,)).astype(bool),
        "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("metadata", [None, {"format": "pt"},
                                      {"format": "pt", "a": "1"}])
def test_safetensors_writer_matches_the_library(metadata, tmp_path):
    """Byte-equal files with at most one metadata key (the library writes
    several keys in its hash map's order, which changes between runs);
    with more, the parsed headers are equal."""
    from safetensors import safe_open
    from safetensors.numpy import save_file as lib_save_file

    arrays = _arrays(np.random.default_rng(3))
    lib_save_file(arrays, tmp_path / "lib.safetensors", metadata=metadata)
    tensors = {k: _to_torch(v) for k, v in arrays.items()}
    tensors["model.layers.0.w"] = tensors["model.layers.0.w"].T.contiguous().T
    sio.save_file(tensors, tmp_path / "torch.safetensors", metadata=metadata)
    want = (tmp_path / "lib.safetensors").read_bytes()
    got = (tmp_path / "torch.safetensors").read_bytes()
    if metadata is None or len(metadata) == 1:
        assert got == want
    else:
        n = int.from_bytes(want[:8], "little")
        assert got[:8] == want[:8] and got[8 + n:] == want[8 + n:]
        assert json.loads(got[8:8 + n]) == json.loads(want[8:8 + n])
    with safe_open(tmp_path / "torch.safetensors", framework="np") as f:
        assert sorted(f.keys()) == sorted(arrays)
        assert f.metadata() == metadata
        for k, a in arrays.items():
            got = f.get_tensor(k)
            assert got.dtype == a.dtype and got.shape == a.shape, k
            assert np.array_equal(got.reshape(-1).view(np.uint8),
                                  a.reshape(-1).view(np.uint8)), k
    mine = sio.SafetensorsFile(tmp_path / "lib.safetensors")
    assert mine.keys() == sorted(arrays) and mine.metadata == metadata
    for k, t in tensors.items():
        got = mine.get(k)
        assert got.dtype == t.dtype and got.shape == t.shape, k
        assert np.array_equal(_bits(got), _bits(t)), k


def test_safetensors_refuses_unknown_dtypes(tmp_path):
    with pytest.raises(TypeError, match="no code"):
        sio.save_file({"c": torch.zeros(2, dtype=torch.complex64)},
                      tmp_path / "c.safetensors")
    with pytest.raises(TypeError, match="strings"):
        sio.save_file({"x": torch.zeros(2)}, tmp_path / "m.safetensors",
                      metadata={"n": 1})
    header = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [2],
                               "data_offsets": [0, 2]}}).encode()
    header += b" " * (-len(header) % 8)
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(len(header).to_bytes(8, "little") + header + b"\0\0")
    with pytest.raises(TypeError, match="not supported"):
        sio.SafetensorsFile(bad)
    short = tmp_path / "short.safetensors"
    header = json.dumps({"x": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 16]}}).encode()
    header += b" " * (-len(header) % 8)
    short.write_bytes(len(header).to_bytes(8, "little") + header + b"\0" * 8)
    with pytest.raises(ValueError, match="offsets"):
        sio.SafetensorsFile(short)


# -- the hub path over TLTPU_HUB_SOURCE (tests/test_hub.py's cases) --------
@pytest.fixture()
def fake_hub(tmp_path, monkeypatch):
    """A tiny 4-layer llama split into two shards, laid out as
    ``<hub>/<repo_id>/``: layers 0-1 and every non-layer tensor in shard 1,
    layers 2-3 in shard 2."""
    import transformers

    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64,
    )
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg)
    model.eval()
    src = tmp_path / "src"
    model.save_pretrained(src, safe_serialization=True)
    repo_dir = tmp_path / "hub" / HUB_REPO
    repo_dir.mkdir(parents=True)
    (repo_dir / "config.json").write_text((src / "config.json").read_text())
    (repo_dir / "tokenizer_config.json").write_text("{}")
    reader = tloader.CheckpointReader(src)
    shards = ({}, {})
    weight_map = {}
    for name in reader.names():
        layer = None
        if ".layers." in name:
            layer = int(name.split(".layers.")[1].split(".")[0])
        i = int(layer is not None and layer >= 2)
        shards[i][name] = reader.get(name)
        weight_map[name] = f"model-0000{i + 1}-of-00002.safetensors"
    for i, shard in enumerate(shards):
        sio.save_file(shard, repo_dir / f"model-0000{i + 1}-of-00002"
                      ".safetensors")
    (repo_dir / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
    monkeypatch.setenv("TLTPU_HUB_SOURCE", str(tmp_path / "hub"))
    monkeypatch.setenv("TLTPU_CACHE", str(tmp_path / "cache"))
    return model


def test_hub_refs_local_bad_and_dot_segments(tmp_path, monkeypatch):
    monkeypatch.setenv("TLTPU_HUB_SOURCE", str(tmp_path / "hub"))
    monkeypatch.setenv("TLTPU_CACHE", str(tmp_path / "cache"))
    d = tmp_path / "ckpt"
    d.mkdir()
    assert tloader.resolve_checkpoint(d) == d
    for ref in ("not a repo id at all", "../escape", "escape/..",
                "nonexistent/.", "no-slash"):
        assert not Path(ref).exists()
        with pytest.raises(FileNotFoundError):
            tloader.resolve_checkpoint(ref)
    assert not (tmp_path / "cache").exists()


def test_hub_config_only_and_layer_range_shards(fake_hub):
    d = tloader.resolve_checkpoint(HUB_REPO, config_only=True)
    assert (d / "config.json").exists()
    assert not list(d.glob("*.safetensors"))
    cfg = tregistry.config_from_hf(json.loads((d / "config.json").read_text()))
    assert cfg.n_layers == 4
    d = tloader.resolve_checkpoint(HUB_REPO, layer_range=(0, 2))
    assert (d / "model-00001-of-00002.safetensors").exists()
    assert not (d / "model-00002-of-00002.safetensors").exists()
    assert (d / "tokenizer_config.json").exists()
    d2 = tloader.resolve_checkpoint(HUB_REPO, layer_range=(0, 4))
    assert d2 == d and (d / "model-00002-of-00002.safetensors").exists()
    # optional files the repo lacks are recorded once, not re-probed
    absent = json.loads((d / ".absent.json").read_text())
    assert "tokenizer.json" in absent
    with pytest.raises(FileNotFoundError):
        tloader._hub_fetch(HUB_REPO, "tokenizer.json", d, required=True)


def test_hub_load_by_repo_id_and_stage_slice(fake_hub):
    cfg, params = tloader.load_params(HUB_REPO, dtype=torch.float32,
                                      device="cpu")
    toks = np.random.default_rng(0).integers(0, 128, (2, 12))
    with torch.no_grad():
        ref = fake_hub(input_ids=torch.from_numpy(toks)).logits.numpy()
        got, _ = forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-3)
    _, part = tloader.load_params(HUB_REPO, layer_range=(2, 4),
                                  dtype=torch.float32, device="cpu")
    full = _leaves(params["layers"])
    for name, leaf in _leaves(part["layers"]).items():
        assert leaf.shape[0] == 2
        assert torch.equal(leaf, full[name][2:4]), name
    _, jpart = jloader.load_params(HUB_REPO, layer_range=(2, 4),
                                   dtype=jnp.float32)
    _assert_trees_bitwise(part, params_from_jax(jax.device_get(jpart),
                                                device="cpu"))
