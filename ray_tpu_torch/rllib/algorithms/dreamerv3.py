"""DreamerV3, model-based RL: learn a latent world model, act in dreams;
counterpart of the JAX package's `rllib/algorithms/dreamerv3.py` (parity:
the reference's `rllib/algorithms/dreamerv3/`, an RSSM world model and an
actor-critic trained in imagination, Hafner et al. 2023).

As there, the algorithm is functions of a parameter tree: `_observe` (the
RSSM posterior over a replayed [B, T] batch and the ELBO losses),
`_imagine` (a prior rollout driven by the actor) and `_update` (the world
model's step, then the actor's and critic's). The JAX package's
`lax.scan`s (observe, imagine, the reversed lambda-return) are Python
loops here and an autograd graph through them stands in for `jax.grad`.
Kept from the reference: symlog targets, percentile return normalization
(`jnp.percentile`'s linear rule), KL balancing with free bits,
straight-through categorical latents with 1% unimix, and the critic's EMA
regularizer. Both optimizers are optax's chain
`clip_by_global_norm` + `adamw` (weight decay 1e-4).

Randomness: the categorical draws are Gumbel-max (`jax.random.categorical`'s
method), their Gumbel noise drawn from a `torch.Generator` or fed, in
draw order, by a test (`_Gumbel`). Collection owns a vector env from the
port's `env.base.make_vec` (same-step autoreset; the built-in ids need no
gymnasium) and acts on the CPU with a CPU copy of the params taken once an
iteration, as the env runners do; the recurrent acting state (h, z) lives
with the env.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (
    clip_by_global_norm,
    read_metrics,
)
from ray_tpu_torch.rllib.core.rl_module import (
    fp32_products,
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
    tree_map,
)
from ray_tpu_torch.train.optim import adamw


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _mlp_init(gen, sizes, scale=None):
    params = []
    for i in range(len(sizes) - 1):
        s = scale if scale is not None else 1.0 / math.sqrt(sizes[i])
        params.append({
            "w": torch.empty((sizes[i], sizes[i + 1])).uniform_(
                -s, s, generator=gen),
            "b": torch.zeros(sizes[i + 1]),
        })
    return params


def _mlp(params, x, act=F.silu, final_act=False):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


class _Gumbel:
    """The Gumbel noise of an update's categorical draws: from `gen`, or
    popped in draw order from `fed` (tensors a test drew with the JAX
    package's keys)."""

    def __init__(self, gen=None, fed=None):
        self.gen = gen
        self.fed = list(fed) if fed is not None else None

    def __call__(self, shape, device) -> torch.Tensor:
        if self.fed is not None:
            g = self.fed.pop(0)
            if tuple(g.shape) != tuple(shape):
                raise ValueError(f"fed Gumbel noise {tuple(g.shape)} where "
                                 f"the draw is {tuple(shape)}")
            return torch.as_tensor(g, device=device)
        u = torch.rand(shape, generator=self.gen, device=device)
        u = u.clamp_(min=torch.finfo(u.dtype).tiny)
        return -torch.log(-torch.log(u))


def _categorical(logits, gumbel: _Gumbel):
    return torch.argmax(logits + gumbel(logits.shape, logits.device), dim=-1)


@dataclasses.dataclass(frozen=True)
class RSSMSpec:
    """Sizes of the recurrent state-space model."""

    obs_dim: int
    num_actions: int
    deter: int = 256
    classes: int = 16   # categorical latents: `groups` x `classes`
    groups: int = 16
    hidden: int = 256
    discrete_actions: bool = True

    @property
    def stoch(self) -> int:
        return self.classes * self.groups

    @property
    def feat(self) -> int:
        return self.deter + self.stoch

    def init_params(self, seed=0, device="cuda") -> dict:
        """The JAX package's tree and init ranges, drawn from a CPU
        generator seeded with `seed`, then moved to `device`."""
        gen = torch.Generator().manual_seed(int(seed))
        d, s, hdn = self.deter, self.stoch, self.hidden
        tree = {
            "encoder": _mlp_init(gen, (self.obs_dim, hdn, hdn)),
            # the GRU over [z, a] -> deter: one fused 3-gate product each
            "gru_in": _mlp_init(gen, (s + self.num_actions, 3 * d))[0],
            "gru_h": _mlp_init(gen, (d, 3 * d))[0],
            "prior": _mlp_init(gen, (d, hdn, s)),
            "post": _mlp_init(gen, (d + hdn, hdn, s)),
            "decoder": _mlp_init(gen, (self.feat, hdn, hdn, self.obs_dim)),
            "reward": _mlp_init(gen, (self.feat, hdn, 1), scale=1e-4),
            "cont": _mlp_init(gen, (self.feat, hdn, 1)),
            "actor": _mlp_init(gen, (self.feat, hdn, self.num_actions),
                               scale=0.01),
            "critic": _mlp_init(gen, (self.feat, hdn, 1), scale=1e-4),
        }
        dev = resolve_device(device)
        return tree_map(lambda t: t.to(dev), tree)

    # ---- RSSM cells ----

    def _gru(self, p, h, x):
        d = self.deter
        gi = x @ p["gru_in"]["w"] + p["gru_in"]["b"]
        gh = h @ p["gru_h"]["w"] + p["gru_h"]["b"]
        r = torch.sigmoid(gi[..., :d] + gh[..., :d])
        u = torch.sigmoid(gi[..., d:2 * d] + gh[..., d:2 * d])
        cand = torch.tanh(gi[..., 2 * d:] + r * gh[..., 2 * d:])
        return u * cand + (1 - u) * h

    def _unimix(self, logits):
        """1% uniform-mixed grouped log-probs [..., groups, classes]; the
        draws and both KL terms use this distribution."""
        shp = logits.shape[:-1] + (self.groups, self.classes)
        probs = (0.99 * torch.softmax(logits.reshape(shp), dim=-1)
                 + 0.01 / self.classes)
        return torch.log(probs)

    def _sample_latent(self, mixed_lg, gumbel: _Gumbel):
        """Straight-through one-hot categorical from mixed log-probs
        [..., groups, classes] -> [..., stoch]."""
        idx = _categorical(mixed_lg, gumbel)
        one = F.one_hot(idx, self.classes).to(mixed_lg.dtype)
        probs = torch.exp(mixed_lg)
        one = one + probs - probs.detach()  # straight-through
        return one.reshape(mixed_lg.shape[:-2] + (self.stoch,))

    def obs_step(self, p, h, z, a, embed, is_first, gumbel: _Gumbel):
        """One posterior step, all [B, ...] -> (h, z, prior log-probs,
        posterior log-probs), the log-probs unimixed and grouped."""
        mask = 1.0 - is_first[..., None]
        h = h * mask
        z = z * mask
        a = a * mask
        h = self._gru(p, h, torch.cat([z, a], -1))
        prior_lg = self._unimix(_mlp(p["prior"], h))
        post_lg = self._unimix(_mlp(p["post"], torch.cat([h, embed], -1)))
        z = self._sample_latent(post_lg, gumbel)
        return h, z, prior_lg, post_lg

    def img_step(self, p, h, z, a, gumbel: _Gumbel):
        h = self._gru(p, h, torch.cat([z, a], -1))
        prior_lg = self._unimix(_mlp(p["prior"], h))
        return h, self._sample_latent(prior_lg, gumbel)

    @staticmethod
    def _kl(lhs_lg, rhs_lg):
        """KL(lhs || rhs) over grouped-categorical log-probs, summed."""
        return (torch.exp(lhs_lg) * (lhs_lg - rhs_lg)).sum(-1).sum(-1)


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DreamerV3)
        self.batch_size_B = 8          # replayed fragments per update
        self.batch_length_T = 32       # fragment length
        self.horizon_H = 10            # imagination horizon
        self.model_size = {"deter": 256, "hidden": 256,
                           "classes": 16, "groups": 16}
        self.gamma = 0.99
        self.gae_lambda = 0.95
        self.entropy_scale = 3e-3
        self.free_bits = 1.0
        self.kl_dyn_scale = 0.5
        self.kl_rep_scale = 0.1
        self.critic_ema_decay = 0.98
        self.replay_capacity = 500     # fragments
        self.num_updates_per_iter = 8
        self.num_envs = 8
        self.lr = 4e-4
        self.actor_critic_lr = 1e-4

    def training(self, *, batch_size_B=None, batch_length_T=None,
                 horizon_H=None, model_size=None, entropy_scale=None,
                 num_updates_per_iter=None, replay_capacity=None,
                 actor_critic_lr=None, **kw):
        super().training(**kw)
        for k, v in (("batch_size_B", batch_size_B),
                     ("batch_length_T", batch_length_T),
                     ("horizon_H", horizon_H), ("model_size", model_size),
                     ("entropy_scale", entropy_scale),
                     ("num_updates_per_iter", num_updates_per_iter),
                     ("replay_capacity", replay_capacity),
                     ("actor_critic_lr", actor_critic_lr)):
            if v is not None:
                setattr(self, k, v)
        return self


_AC = ("actor", "critic")


def lambda_returns(rew, disc, values, lam):
    """lambda-returns over [H, N], time-reversed: rets[t] = rew[t] +
    disc[t] ((1 - lam) values[t + 1] + lam rets[t + 1]), seeded with
    values[H] (`values` is [H + 1, N])."""
    nxt = values[-1]
    rets = []
    for t in range(rew.shape[0] - 1, -1, -1):
        nxt = rew[t] + disc[t] * ((1 - lam) * values[t + 1] + lam * nxt)
        rets.append(nxt)
    return torch.stack(rets[::-1])


def return_range(rets):
    """(5th, 95th) percentile of the returns by `jnp.percentile`'s linear
    rule: position q (n - 1) in fp32, the two neighbours weighted by its
    fraction. The positions are host numbers (n is a shape), so no value
    is read back, where `torch.quantile` checks its q on the device."""
    s = torch.sort(rets.reshape(-1)).values
    n = s.shape[0]
    out = []
    for q in (0.05, 0.95):
        pos = np.float32(q) * np.float32(n - 1)
        lo = int(np.floor(pos))
        hi = min(int(np.ceil(pos)), n - 1)
        w = np.float32(pos - lo)
        out.append(s[lo] * float(np.float32(1) - w) + s[hi] * float(w))
    return tuple(out)


class DreamerV3:
    """Self-contained: owns the vector env (the recurrent acting state
    rides with it), the fragment replay and the update. The params live
    on `config.device` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, config: DreamerV3Config):
        from ray_tpu_torch.rllib.env.base import make_vec
        self.config = c = config
        self.device = resolve_device(c.device)
        self.env = make_vec(c.env, c.num_envs, **(c.env_config or {}))
        obs_dim = int(np.prod(self.env.single_observation_space.shape))
        num_actions = int(self.env.single_action_space.n)
        ms = c.model_size
        self.spec = RSSMSpec(obs_dim=obs_dim, num_actions=num_actions,
                             deter=ms["deter"], hidden=ms["hidden"],
                             classes=ms["classes"], groups=ms["groups"])
        self.params = tree_map(lambda t: t.requires_grad_(True),
                               self.spec.init_params(c.seed, self.device))
        self.critic_ema = tree_map(lambda t: t.detach().clone(),
                                   self.params["critic"])
        self._wm_leaves = tree_leaves(
            {k: v for k, v in self.params.items() if k not in _AC})
        self._ac_leaves = tree_leaves({k: self.params[k] for k in _AC})
        self.clip = c.grad_clip or 100.0
        self.wm_opt = adamw(c.lr).init(dict(enumerate(self._wm_leaves)))
        self.ac_opt = adamw(c.actor_critic_lr).init(
            dict(enumerate(self._ac_leaves)))
        # the return normalizer: an EMA of the 5th-95th percentile range
        self.retnorm = torch.ones((), device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            c.seed + 1)
        self._act_gen = torch.Generator().manual_seed(c.seed)

        obs, _ = self.env.reset(seed=c.seed)
        self._obs = self._flat(obs)
        E = c.num_envs
        self._h = np.zeros((E, self.spec.deter), np.float32)
        self._z = np.zeros((E, self.spec.stoch), np.float32)
        self._a = np.zeros((E, num_actions), np.float32)
        self._is_first = np.ones((E,), np.float32)
        self._ep_ret = np.zeros(E)
        self.completed_returns: list[float] = []
        self.buffer: list[dict] = []
        self.iteration = 0
        self._timesteps = 0

    # ---------------- acting ----------------

    @staticmethod
    def _flat(obs):
        return np.asarray(obs, np.float32).reshape(len(obs), -1)

    def _act(self, params, h, z, a, obs, is_first):
        """One acting step on the CPU -> (h, z, action), numpy."""
        g = _Gumbel(self._act_gen)
        t = torch.from_numpy
        embed = _mlp(params["encoder"], symlog(t(obs)), final_act=True)
        h, z, _, _ = self.spec.obs_step(params, t(h), t(z), t(a), embed,
                                        t(is_first), g)
        logits = _mlp(params["actor"], torch.cat([h, z], -1))
        return h.numpy(), z.numpy(), _categorical(logits, g).numpy()

    @torch.no_grad()
    def _collect(self, steps: int) -> dict:
        """Step the vector env `steps` times with a CPU copy of the params;
        returns the [T, E, ...] fragment and pushes one fragment per env
        into the replay."""
        c = self.config
        E, T = c.num_envs, steps
        params = params_from_numpy(params_to_numpy(self.params), "cpu")
        frag = {
            "obs": np.empty((T, E, self.spec.obs_dim), np.float32),
            "action": np.empty((T, E), np.int64),
            "reward": np.zeros((T, E), np.float32),
            "cont": np.ones((T, E), np.float32),
            "is_first": np.zeros((T, E), np.float32),
        }
        with fp32_products():
            for t in range(T):
                h, z, action = self._act(params, self._h, self._z, self._a,
                                         self._obs, self._is_first)
                frag["obs"][t] = self._obs
                frag["is_first"][t] = self._is_first
                frag["action"][t] = action
                obs, rew, term, trunc, _ = self.env.step(action)
                done = np.logical_or(term, trunc)
                frag["reward"][t] = rew
                frag["cont"][t] = 1.0 - np.asarray(term, np.float32)
                self._ep_ret += rew
                for i in np.flatnonzero(done):
                    self.completed_returns.append(float(self._ep_ret[i]))
                    self._ep_ret[i] = 0.0
                self._h, self._z = h, z
                self._a = np.eye(self.spec.num_actions,
                                 dtype=np.float32)[action]
                self._is_first = np.asarray(done, np.float32)
                self._obs = self._flat(obs)
                self._timesteps += E
        for e in range(E):
            self.buffer.append({k: v[:, e] for k, v in frag.items()})
        if len(self.buffer) > c.replay_capacity:
            del self.buffer[:len(self.buffer) - c.replay_capacity]
        return frag

    # ---------------- the update ----------------

    def _observe(self, params, batch, gumbel: _Gumbel):
        """The RSSM posterior over [B, T, ...] -> (world-model loss,
        (feat [B, T, F], metrics))."""
        spec, c = self.spec, self.config
        B, T = batch["obs"].shape[:2]
        embed = _mlp(params["encoder"], symlog(batch["obs"]),
                     final_act=True)
        a_onehot = F.one_hot(batch["action"].long(),
                             spec.num_actions).to(embed.dtype)
        # the previous action enters each step (shifted by one)
        a_prev = torch.cat([torch.zeros_like(a_onehot[:, :1]),
                            a_onehot[:, :-1]], 1)
        h = embed.new_zeros((B, spec.deter))
        z = embed.new_zeros((B, spec.stoch))
        hs, zs, priors, posts = [], [], [], []
        for t in range(T):
            h, z, prior_lg, post_lg = spec.obs_step(
                params, h, z, a_prev[:, t], embed[:, t],
                batch["is_first"][:, t], gumbel)
            hs.append(h)
            zs.append(z)
            priors.append(prior_lg)
            posts.append(post_lg)
        prior_lg = torch.stack(priors, 1)  # [B, T, groups, classes]
        post_lg = torch.stack(posts, 1)
        feat = torch.cat([torch.stack(hs, 1), torch.stack(zs, 1)], -1)

        recon = _mlp(params["decoder"], feat)
        rew_pred = _mlp(params["reward"], feat)[..., 0]
        cont_pred = _mlp(params["cont"], feat)[..., 0]
        recon_loss = torch.square(recon - symlog(batch["obs"])).sum(-1)
        rew_loss = torch.square(rew_pred - symlog(batch["reward"]))
        # optax.sigmoid_binary_cross_entropy's formula
        x, y = cont_pred, batch["cont"]
        cont_loss = (torch.relu(x) - x * y
                     + torch.log1p(torch.exp(-torch.abs(x))))
        dyn = torch.clamp(spec._kl(post_lg.detach(), prior_lg),
                          min=c.free_bits)
        rep = torch.clamp(spec._kl(post_lg, prior_lg.detach()),
                          min=c.free_bits)
        wm_loss = (recon_loss + rew_loss + cont_loss
                   + c.kl_dyn_scale * dyn + c.kl_rep_scale * rep).mean()
        metrics = {"recon_loss": recon_loss.mean(),
                   "reward_loss": rew_loss.mean(),
                   "continue_loss": cont_loss.mean(),
                   "kl": dyn.mean()}
        return wm_loss, (feat, metrics)

    def _imagine(self, params, start_feat, gumbel: _Gumbel):
        """An actor-driven prior rollout from (flattened) posterior states
        -> (feats [H, N, F], logp [H, N], entropy [H, N], last [N, F])."""
        spec, c = self.spec, self.config
        h = start_feat[:, :spec.deter]
        z = start_feat[:, spec.deter:]
        feats, logps, ents = [], [], []
        for _ in range(c.horizon_H):
            feat = torch.cat([h, z], -1)
            logits = _mlp(params["actor"], feat)
            a = _categorical(logits, gumbel)
            logp = F.log_softmax(logits, dim=-1)
            ents.append(-(torch.exp(logp) * logp).sum(-1))
            logps.append(logp.gather(-1, a[:, None])[:, 0])
            feats.append(feat)
            a1 = F.one_hot(a, spec.num_actions).to(feat.dtype)
            h, z = spec.img_step(params, h, z, a1, gumbel)
        return (torch.stack(feats), torch.stack(logps), torch.stack(ents),
                torch.cat([h, z], -1))

    def _ac_loss(self, wm, start, gumbel: _Gumbel):
        """The actor's and critic's loss over an imagined rollout (the
        world model `wm` held fixed) -> (loss, aux)."""
        c = self.config
        full = {**wm, **{k: self.params[k] for k in _AC}}
        feats, logp, ent, last = self._imagine(full, start, gumbel)
        rew = symexp(_mlp(full["reward"], feats)[..., 0])
        cont = torch.sigmoid(_mlp(full["cont"], feats)[..., 0])
        disc = c.gamma * cont
        # the critic predicts in symlog space; bootstrap and advantage
        # work in raw return space
        value_sym = _mlp(full["critic"], feats)[..., 0]
        value = symexp(value_sym)
        last_v = symexp(_mlp(full["critic"], last)[..., 0])
        values = torch.cat([value, last_v[None]], 0)
        rets = lambda_returns(rew, disc, values, c.gae_lambda).detach()
        lo, hi = return_range(rets)
        scale = torch.clamp(hi - lo, min=1.0)
        adv = (rets - value) / torch.maximum(self.retnorm, scale).detach()
        weight = torch.cumprod(
            torch.cat([torch.ones_like(disc[:1]), disc[:-1]], 0), 0)
        actor_loss = -(weight * (logp * adv.detach()
                                 + c.entropy_scale * ent)).mean()
        v_ema_sym = _mlp(self.critic_ema, feats)[..., 0]
        critic_loss = (weight * (
            torch.square(value_sym - symlog(rets))
            + 0.3 * torch.square(value_sym - v_ema_sym.detach()))).mean()
        aux = {"actor_loss": actor_loss, "critic_loss": critic_loss,
               "actor_entropy": ent.mean(), "scale": scale,
               "imagined_return": rets.mean()}
        return actor_loss + critic_loss, aux

    def _step(self, loss, leaves, opt) -> None:
        """clip_by_global_norm, then one AdamW step on `leaves`."""
        grads = torch.autograd.grad(loss, leaves)
        for p, g in zip(leaves, clip_by_global_norm(list(grads), self.clip)):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def _update(self, batch: dict, gumbel: _Gumbel | None = None) -> dict:
        """One update on a batch of device tensors -> its metrics, on the
        device."""
        c = self.config
        gumbel = gumbel or _Gumbel(self._gen)
        with fp32_products():
            # ---- world model ----
            wm_loss, (feat, wm_metrics) = self._observe(self.params, batch,
                                                        gumbel)
            self._step(wm_loss, self._wm_leaves, self.wm_opt)
            # ---- imagination (the updated world model held fixed) ----
            wm = {k: tree_map(torch.Tensor.detach, v)
                  for k, v in self.params.items() if k not in _AC}
            start = feat.detach().reshape(-1, self.spec.feat)
            ac_loss, aux = self._ac_loss(wm, start, gumbel)
            self._step(ac_loss, self._ac_leaves, self.ac_opt)
            d = c.critic_ema_decay
            with torch.no_grad():
                for e, p in zip(tree_leaves(self.critic_ema),
                                tree_leaves(self.params["critic"])):
                    e.copy_(d * e + (1 - d) * p)
                self.retnorm = 0.99 * self.retnorm + 0.01 * aux.pop("scale")
        return {**wm_metrics, **{k: v.detach() for k, v in aux.items()},
                "world_model_loss": wm_loss.detach()}

    def _replay_batch(self, idx) -> dict:
        """The fragments `idx` ([..., B]) stacked [..., B, T, ...], one
        host-to-device copy a key."""
        idx = np.asarray(idx)
        return {k: torch.as_tensor(
            np.stack([self.buffer[i][k] for i in idx.reshape(-1)])
            .reshape(idx.shape + self.buffer[0][k].shape), device=self.device)
            for k in ("obs", "action", "reward", "cont", "is_first")}

    # ---------------- the Trainable surface ----------------

    def training_step(self) -> dict:
        c = self.config
        self._collect(c.batch_length_T)
        if len(self.buffer) < c.batch_size_B or not c.num_updates_per_iter:
            return {}
        rng = np.random.default_rng(c.seed + self.iteration)
        # the iteration's batches drawn in the JAX package's order and
        # copied to the device at once (a copy a batch would wait for the
        # device's queue before every update)
        idx = np.stack([rng.integers(0, len(self.buffer), c.batch_size_B)
                        for _ in range(c.num_updates_per_iter)])
        batches = self._replay_batch(idx)
        metrics = {}
        for i in range(len(idx)):
            metrics = self._update({k: v[i] for k, v in batches.items()})
        return read_metrics(metrics) if metrics else {}

    def train(self) -> dict:
        t0 = time.perf_counter()
        self.iteration += 1
        result = self.training_step()
        rets = self.completed_returns[-50:]
        if rets:
            result["episode_return_mean"] = float(np.mean(rets))
        result.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "time_this_iter_s": time.perf_counter() - t0,
        })
        return result

    def get_weights(self):
        return params_to_numpy(self.params)

    def stop(self):
        self.env.close()
