"""PyTorch port, training path: `loss_fn` and its gradients, the AdamW
train step and state save/restore, held against the JAX package
(`ray_tpu.models.loss_fn`, `ray_tpu.train.make_train_step` with
`optax.adamw`) on the same weights and tokens.

Weights come from `ray_tpu.models.init_params` and cross with
`params_from_numpy`; tokens from a numpy seed. The JAX side runs on the
CPU as its own tests do: the flash kernels in interpret mode for the
gradient checks, the dense reference attention for the trajectory (the
port's autograd Function runs its plain forward and backward here; the
CUDA kernels are checked against those on the card by chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from ray_tpu.models import configs as j_configs
from ray_tpu.models import init_params as j_init_params
from ray_tpu.models import loss_fn as j_loss_fn
from ray_tpu.models import param_logical_axes as j_param_logical_axes
from ray_tpu.models import transformer as j_transformer
from ray_tpu.train.step import make_train_step as j_make_train_step
from ray_tpu_torch.models import (configs, loss_fn, param_logical_axes,
                                  params_from_numpy)
from ray_tpu_torch.models import transformer as t_transformer
from ray_tpu_torch.ops import attention as t_attention
from ray_tpu_torch.train import (adamw, make_train_step, restore_state,
                                 save_state)
from ray_tpu_torch.train.optim import tree_leaves


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


def _weights(cfg, seed=0):
    """The JAX package's init as numpy, for both sides."""
    return jax.tree.map(np.asarray,
                        j_init_params(cfg, jax.random.PRNGKey(seed)))


def _leaves_requiring_grad(tree_np):
    t = params_from_numpy(tree_np, device="cpu")
    for x in tree_leaves(t):
        x.requires_grad_(True)
    return t


def _batch(form, b=2, s=32, vocab=256, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    if form == "tokens":
        return {"tokens": tok}
    mask = (rng.random((b, s)) < 0.7).astype(np.float32)
    return {"inputs": tok[:, :-1], "targets": tok[:, 1:], "mask": mask}


def _port_value_and_grad(params_np, batch_np, cfg, **kw):
    params = _leaves_requiring_grad(params_np)
    loss = loss_fn(params, {k: torch.tensor(v) for k, v in batch_np.items()},
                   cfg, **kw)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    names = sorted(_flat(params))   # tree_leaves' order
    return loss, dict(zip(names, grads))


def _grads_close(got: dict, want_tree, rel: float):
    want = _flat(want_tree)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=rel * max(1e-3, np.abs(w).max()),
            err_msg=name)


# fp32 on both sides, the same math in another summation order: the loss
# to 1e-6 relative, each gradient leaf to 1e-4 of its largest entry.
_LOSS_RTOL, _GRAD_REL = 1e-6, 1e-4


@pytest.mark.parametrize("form", ["tokens", "inputs_targets_mask"])
def test_loss_and_grads_match_jax_interpret(form):
    """loss_fn and every gradient leaf on tiny() fp32 against
    jax.value_and_grad(loss_fn) with the interpret-mode flash kernels;
    both batch forms, the second with a position mask."""
    cfg_j = j_configs.tiny(attn_impl="interpret")
    w = _weights(cfg_j)
    batch = _batch(form)
    lj, gj = jax.value_and_grad(
        lambda p: j_loss_fn(p, jax.tree.map(jnp.asarray, batch), cfg_j))(
            jax.tree.map(jnp.asarray, w))
    before = t_attention.bwd_dkv_launches["plain"]
    lt, gt = _port_value_and_grad(w, batch, configs.tiny())
    assert t_attention.bwd_dkv_launches["plain"] == before + 2  # 2 layers
    assert lt.dtype == torch.float32 and lt.dim() == 0
    np.testing.assert_allclose(lt.item(), float(lj), rtol=_LOSS_RTOL)
    _grads_close(gt, gj, _GRAD_REL)


def test_chunked_loss_matches_jax(monkeypatch):
    """The chunked, rematerialized head (forced on tiny() by lowering the
    size threshold, 16-token chunks) gives JAX's loss and gradients (JAX
    unchunked: the same function)."""
    cfg_j = j_configs.tiny(attn_impl="reference")
    w = _weights(cfg_j, seed=2)
    batch = _batch("tokens", seed=3)
    lj, gj = jax.value_and_grad(
        lambda p: j_loss_fn(p, jax.tree.map(jnp.asarray, batch), cfg_j))(
            jax.tree.map(jnp.asarray, w))
    monkeypatch.setattr(t_transformer, "CHUNK_MIN_BYTES", 0)
    assert t_transformer.uses_loss_chunks(2, 32, 256, 16)
    lt, gt = _port_value_and_grad(w, batch, configs.tiny(), loss_chunk=16)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=_LOSS_RTOL)
    _grads_close(gt, gj, _GRAD_REL)


def test_xent_chunks_match_jax_lax_map():
    """The chunk body itself: port `_xent` over 3 chunks under checkpoint
    against the JAX package's `lax.map(jax.checkpoint(_xent))`, values and
    the gradients of x and head."""
    rng = np.random.default_rng(4)
    b, s, d, vocab, chunk = 2, 24, 16, 50, 8
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    head = rng.normal(size=(d, vocab)).astype(np.float32) / 4
    tgt = rng.integers(0, vocab, (b, s)).astype(np.int32)

    def j_total(x, head):
        xc = x.reshape(b, s // chunk, chunk, d).transpose(1, 0, 2, 3)
        tc = jnp.asarray(tgt).reshape(b, s // chunk, chunk).transpose(1, 0, 2)
        ll = jax.lax.map(jax.checkpoint(
            lambda a: j_transformer._xent(a[0], head, a[1])), (xc, tc))
        return jnp.sum(ll * jnp.arange(1, ll.size + 1).reshape(ll.shape))

    vj, (gxj, ghj) = jax.value_and_grad(j_total, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.tensor(x, requires_grad=True)
    th = torch.tensor(head, requires_grad=True)
    tt = torch.tensor(tgt).long()
    ll = torch.stack([torch.utils.checkpoint.checkpoint(
        t_transformer._xent, tx[:, i:i + chunk], th, tt[:, i:i + chunk],
        use_reentrant=False) for i in range(0, s, chunk)])  # [nc, b, chunk]
    vt = (ll * torch.arange(1, ll.numel() + 1).reshape(ll.shape)).sum()
    gx, gh = torch.autograd.grad(vt, (tx, th))
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-5)
    for g, w in ((gx, gxj), (gh, ghj)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_loss_chunks_at_the_train_shape():
    """At the bench's 16 x 1024 batch with vocab 32000 the chunked path is
    the one taken (2.1 GB of fp32 logits > 1 GiB), in 512-token chunks;
    at the test sizes it is not."""
    assert t_transformer.uses_loss_chunks(16, 1024, 32000, 512)
    assert not t_transformer.uses_loss_chunks(2, 32, 256, 512)
    assert not t_transformer.uses_loss_chunks(16, 1000, 32000, 512)


def test_remat_gives_the_same_gradients():
    """remat=True recomputes each layer in the backward
    (torch.utils.checkpoint) and must not change loss or gradients."""
    w = _weights(j_configs.tiny(), seed=5)
    batch = _batch("tokens", seed=6)
    l0, g0 = _port_value_and_grad(w, batch, configs.tiny())
    before = t_attention.launches["plain"]
    l1, g1 = _port_value_and_grad(w, batch, configs.tiny(remat=True))
    assert t_attention.launches["plain"] == before + 4   # forward + recompute
    assert l0.item() == l1.item()
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=0, atol=1e-7)


def test_param_logical_axes_match_jax():
    for kw in ({}, {"tie_embeddings": False}):
        assert param_logical_axes(configs.tiny(**kw)) == \
            j_param_logical_axes(j_configs.tiny(**kw))
    assert param_logical_axes(configs.tiny_moe()) == \
        j_param_logical_axes(j_configs.tiny_moe())


def _jax_trajectory(w, batch, steps, lr):
    cfg = j_configs.tiny(attn_impl="reference")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "fsdp", "tp"))
    init_fn, _, compile_for, _ = j_make_train_step(
        lambda p, b: j_loss_fn(p, b, cfg, mesh), optax.adamw(lr), mesh,
        j_param_logical_axes(cfg))
    state = init_fn(jax.tree.map(jnp.asarray, w))
    jb = jax.tree.map(jnp.asarray, batch)
    step = compile_for(state, jb)
    losses = []
    for _ in range(steps):
        state, loss = step(state, jb)
        losses.append(float(loss))
    return losses, state


def _port_steps(state, step_fn, batch, steps):
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, tb)
        losses.append(loss)
    return [x.item() for x in losses], state


def test_trajectory_matches_jax_adamw():
    """5 steps of the port's make_train_step + adamw(1e-3) against the JAX
    make_train_step + optax.adamw(1e-3) on a one-device (dp, fsdp, tp)
    mesh. Losses to 1e-5 relative. Params: all but 0.1 % of the entries of
    each leaf to 1e-6 (fp32 rounding); every entry to 0.1 * lr * steps,
    because AdamW divides each gradient by its own running RMS, so an
    entry whose gradient is at the fp32 noise level (|g| ~ 1e-9 here)
    moves in a direction the rounding decides."""
    w = _weights(j_configs.tiny(), seed=7)
    batch = _batch("tokens", seed=8)
    lr, steps = 1e-3, 5
    j_losses, j_state = _jax_trajectory(w, batch, steps, lr)
    init_fn, step_fn, compile_for, shardings = make_train_step(
        lambda p, b: loss_fn(p, b, configs.tiny()), adamw(lr), device="cpu")
    assert shardings is None
    state = init_fn(params_from_numpy(w, device="cpu"))
    assert compile_for(state, batch) is step_fn
    t_losses, state = _port_steps(state, step_fn, batch, steps)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]
    assert int(state.step) == int(j_state.step) == steps
    want = _flat(j_state.params)
    for name, p in _flat(state.params).items():
        diff = np.abs(p.detach().numpy() - np.asarray(want[name]))
        assert (diff > 1e-6).mean() <= 1e-3, name
        assert diff.max() <= 0.1 * lr * steps, name


def test_adamw_step_matches_optax():
    """One leaf, three steps of random gradients: the port's adamw with
    optax's defaults (weight decay 1e-4, not torch's 1e-2) applies
    optax.adamw's rule, p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p),
    moments kept in the param dtype. Against that rule in float64: 1e-6
    (fp32 rounding). Against optax itself: 1e-5 of the lr * steps the
    leaf can move, since optax forms the bias correction 1 - b2^t in fp32
    (1 - 0.999 keeps about five digits there)."""
    rng = np.random.default_rng(9)
    p0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [rng.normal(size=(64,)).astype(np.float32) for _ in range(3)]
    lr, b1, b2, eps, wd = 0.1, 0.9, 0.999, 1e-8, 1e-4
    exact, m, v = p0.astype(np.float64), 0.0, 0.0
    for t, g in enumerate(grads, 1):
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        u = (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps)
        exact = exact - lr * (u + wd * exact)
    opt = optax.adamw(lr)
    jp = jnp.asarray(p0)
    js = opt.init(jp)
    tp = torch.tensor(p0, requires_grad=True)
    topt = adamw(lr).init({"w": tp})
    assert topt.defaults["weight_decay"] == wd
    for g in grads:
        upd, js = opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.tensor(g)
        topt.step()
    got = tp.detach().numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jp), rtol=0,
                               atol=1e-5 * lr * len(grads))
    assert topt.state[tp]["exp_avg"].dtype == tp.dtype


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    """2 steps, save_state, restore_state into a fresh state, 2 more steps:
    the same losses, params, moments and step as 4 uninterrupted steps."""
    w = _weights(j_configs.tiny(), seed=10)
    batch = _batch("tokens", seed=11)
    init_fn, step_fn, _, _ = make_train_step(
        lambda p, b: loss_fn(p, b, configs.tiny()), adamw(1e-3), device="cpu")
    straight = init_fn(params_from_numpy(w, device="cpu"))
    want, straight = _port_steps(straight, step_fn, batch, 4)

    first = init_fn(params_from_numpy(w, device="cpu"))
    got, first = _port_steps(first, step_fn, batch, 2)
    path = tmp_path / "ckpt" / "state.pt"
    save_state(first, str(path))
    assert sorted(p.name for p in path.parent.iterdir()) == ["state.pt"]
    resumed = restore_state(str(path),
                            init_fn(params_from_numpy(w, device="cpu")))
    assert int(resumed.step) == 2
    more, resumed = _port_steps(resumed, step_fn, batch, 2)
    assert got + more == want
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(straight.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(straight.params)):
        sa, sb = resumed.opt_state.state[a], straight.opt_state.state[b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    assert int(resumed.step) == int(straight.step) == 4


def test_train_entry_points_default_to_cuda_and_refuse_meshes():
    """Without a `device` the train entry points run on CUDA and, on a
    host without a card, raise rather than carry on on the CPU. A mesh
    with sequence parallelism builds the step (tests/test_torch_sp.py
    runs it), and the loss refuses attention within a block under it; a
    JAX Mesh is not a torch DeviceMesh and is refused."""
    import types
    from ray_tpu_torch.parallel import AXES
    cfg = configs.tiny()
    step = lambda p, b: loss_fn(p, b, cfg)  # noqa: E731

    def standin(**deg):
        return types.SimpleNamespace(
            mesh_dim_names=AXES, shape=tuple(deg.get(a, 1) for a in AXES))

    axes = param_logical_axes(cfg)
    _, _, _, shardings = make_train_step(step, adamw(1e-3), standin(sp=2),
                                         axes, device="cpu")
    assert shardings["embed"].spec == ("tp", "fsdp")
    with pytest.raises(ValueError, match="cross them"):
        loss_fn({}, {"tokens": torch.zeros(1, 3, dtype=torch.long)}, cfg,
                mesh=standin(sp=2))
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
               ("dp", "fsdp", "tp"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(step, adamw(1e-3), one, axes, device="cpu")
    # a one-device mesh: the step is built (placing params needs a group)
    _, _, compile_for, shardings = make_train_step(
        step, adamw(1e-3), standin(fsdp=1), axes, device="cpu")
    assert shardings["layers"]["wq"].spec == (None, "fsdp", "tp")
    assert callable(compile_for.state_shardings)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(step, adamw(1e-3))
