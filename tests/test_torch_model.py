"""PyTorch port, model layer: weights carried across from the JAX package
bit-exactly, and the port's forward held against JAX `forward` on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as j_configs
from ray_tpu.models import forward as j_forward
from ray_tpu.models import init_params as j_init_params
from ray_tpu_torch.models import (configs, forward, init_params,
                                  params_from_numpy, params_to_numpy)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the port's CPU tests run beside other test
    files in parallel workers and must not take every core from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _jax_np(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_exact(dtype):
    cfg = j_configs.tiny(dtype=dtype)
    src = _jax_np(j_init_params(cfg, jax.random.PRNGKey(0)))
    tp = params_from_numpy(src, device="cpu")
    want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert all(t.dtype == want_dt for t in _flat(tp).values())
    back = _flat(params_to_numpy(tp))
    for name, a in _flat(src).items():
        b = back[name]
        assert b.dtype == a.dtype and b.shape == a.shape, name
        assert a.tobytes() == b.tobytes(), name
    # the port's tensors are copies: writing them leaves the source intact
    tp["embed"].zero_()
    assert np.asarray(src["embed"], np.float32).any()


def test_params_from_numpy_casts_on_request():
    src = _jax_np(j_init_params(j_configs.tiny(), jax.random.PRNGKey(1)))
    tp = params_from_numpy(src, device="cpu", dtype=torch.bfloat16)
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    assert torch.equal(tp["embed"],
                       torch.tensor(src["embed"]).to(torch.bfloat16))


@pytest.mark.parametrize("name", ["tiny", "tiny_moe", "llama3_8b",
                                  "llama3_1b", "bench_125m", "llama_125m",
                                  "llama3_70b", "mixtral_8x7b", "qwen2_7b"])
def test_named_configs_match_jax(name):
    cfg_j = getattr(j_configs, name)()
    cfg_t = getattr(configs, name)()
    assert {f: getattr(cfg_t, f) for f in cfg_t.__dataclass_fields__} == {
        f: getattr(cfg_j, f) for f in cfg_j.__dataclass_fields__}


@pytest.mark.parametrize("name,kw", [
    ("tiny", {}), ("tiny_moe", {}), ("tiny", {"tie_embeddings": False}),
    ("tiny", {"dtype": "bfloat16"})])
def test_init_params_tree_matches_jax(name, kw):
    """Same dict tree, stacked layer axis and shapes as the JAX package
    (dense, MoE, untied head), dtype from the config."""
    cfg_j = getattr(j_configs, name)(**kw)
    cfg_t = getattr(configs, name)(**kw)
    want = jax.eval_shape(lambda k: j_init_params(cfg_j, k),
                          jax.random.PRNGKey(0))
    got = init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    fw, fg = _flat(want), _flat(got)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        assert tuple(fg[k].shape) == tuple(fw[k].shape), k
        assert fg[k].dtype == cfg_t.torch_dtype, k


def test_init_params_is_seeded():
    cfg = configs.tiny()
    a = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    c = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    std = a["layers"]["wq"].std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.03


_FWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.mark.parametrize("name,dtype", [("tiny", "float32"),
                                        ("tiny_moe", "float32"),
                                        ("tiny", "bfloat16")])
def test_forward_matches_jax(name, dtype):
    """fp32: same math in another summation order (1e-4 on logits of
    magnitude ~1). bf16: both sides round activations to bf16 at the same
    points; allow a few bf16 ulps at the logits' scale."""
    cfg_j = getattr(j_configs, name)(dtype=dtype)
    cfg_t = getattr(configs, name)(dtype=dtype)
    pj = j_init_params(cfg_j, jax.random.PRNGKey(7))
    pt = params_from_numpy(_jax_np(pj), device="cpu")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg_j.vocab, (2, 24)).astype(np.int32)
    want = np.asarray(j_forward(pj, jnp.asarray(tokens), cfg_j))
    got = forward(pt, torch.tensor(tokens, dtype=torch.long), cfg_t)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = _FWD_TOL[dtype] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    if dtype == "float32":
        assert (got.argmax(-1).numpy() == want.argmax(-1)).all()


def test_forward_rejects_sequence_parallel_impls():
    """attn_impl "ring" and "ulysses" without a mesh are a ring (and an
    all-to-all) of one: the same logits as the plain attention within
    fp32 rounding. What is refused is attention within a block under sp:
    any other attn_impl over a mesh with sp > 1 (ValueError)."""
    import types
    from ray_tpu_torch.parallel import AXES
    cfg = configs.tiny()
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    want = forward(p, tokens, cfg)
    for impl in ("ring", "ulysses"):
        got = forward(p, tokens, configs.tiny(attn_impl=impl))
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    mesh = types.SimpleNamespace(mesh_dim_names=AXES,
                                 shape=(1, 1, 1, 2, 1, 1))
    with pytest.raises(ValueError, match="attn_impl='auto'"):
        forward(p, tokens, cfg, mesh=mesh)


def test_entry_points_default_to_cuda():
    """Without a `device`, entry points run on CUDA; on a host without a
    card they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    cfg = configs.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg, EngineConfig(max_slots=1, max_len=32,
                                          prompt_buckets=(16,)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
