"""RLModule: the networks of the RL stack, counterpart of the JAX package's
`rllib/core/rl_module.py`.

As there, a module is a pure-function spec: `init(seed, device)` builds a
parameter tree (nested dicts and lists of tensors, in the reference's
shapes and layouts: dense weights [in, out], conv weights HWIO) and
`forward(params, obs)` is a plain function of it, so a tree carries
across from the JAX package one to one (`params_from_numpy`) and the
same module runs in the learner on the card and in an env runner on the
CPU. `init` draws from a CPU `torch.Generator` seeded with `seed` and
only then moves the tree to `device`, so one seed gives the same
parameters on every device and every learner rank (not the JAX
package's: jax.random and torch streams differ).

Sampling takes an explicit `torch.Generator` on the tensors' device
(Gumbel-max, as `jax.random.categorical` samples). The fp32 products of
the forwards and their backwards run in full fp32 (`fp32_products`, set
around each call and restored after), as the reference's do.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.convert import (
    params_from_numpy,
    params_to_numpy,
    tree_map,
)

__all__ = [
    "MLPSpec", "ActorCriticModule", "QModule", "SquashedGaussianModule",
    "ConvSpec", "CNNActorCriticModule", "MINATAR_FILTERS", "NATURE_FILTERS",
    "module_for_env", "params_from_numpy", "params_to_numpy", "tree_map",
    "tree_leaves", "fp32_products",
]


def tree_leaves(tree) -> list:
    """The leaves in jax.tree_util's order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


@contextlib.contextmanager
def fp32_products():
    """fp32 matrix products and convolutions in full fp32, not TF32 (cuDNN
    takes fp32 convs as TF32 by default), for the calls inside; the
    previous settings come back after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _uniform(gen, shape, scale):
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -scale, scale, generator=gen)


def _dense_init(gen, shape, scale=None):
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _uniform(gen, shape, scale)


def _init_tree(build, seed, device):
    gen = torch.Generator().manual_seed(int(seed))
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), build(gen))


def _categorical(logits, generator):
    """Gumbel-max sample of each row (jax.random.categorical's method):
    -> (action int64, its log-prob)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(u.dtype).tiny)
    action = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    logp = F.log_softmax(logits, dim=-1)
    return action, logp.gather(-1, action[..., None])[..., 0]


@dataclass
class MLPSpec:
    """Shared MLP torso spec."""

    obs_dim: int
    hidden: tuple = (64, 64)
    activation: str = "tanh"

    def build(self, gen) -> list:
        dims = [self.obs_dim, *self.hidden]
        return [{"w": _dense_init(gen, (dims[i], dims[i + 1])),
                 "b": torch.zeros(dims[i + 1])}
                for i in range(len(dims) - 1)]

    def apply(self, params, x):
        act = torch.tanh if self.activation == "tanh" else torch.relu
        for layer in params:
            x = act(x @ layer["w"] + layer["b"])
        return x


def _as_input(obs, like):
    """Observations as fp32 on the params' device (numpy from a runner)."""
    return torch.as_tensor(obs, dtype=torch.float32, device=like.device)


class _DiscreteActor:
    """The three forward modes of a discrete actor-critic (parity: rllib's
    `forward_inference`, `forward_exploration`, `forward_train`)."""

    def forward_train(self, params, obs):
        return self.forward(params, obs)

    def forward_inference(self, params, obs):
        logits, _ = self.forward(params, obs)
        return torch.argmax(logits, dim=-1)

    def forward_exploration(self, params, obs, generator):
        logits, value = self.forward(params, obs)
        action, logp = _categorical(logits, generator)
        return action, logp, value


@dataclass
class ActorCriticModule(_DiscreteActor):
    """Policy and value heads over split MLP torsos (the default module for
    PPO / IMPALA on vector obs)."""

    obs_dim: int
    num_actions: int
    hidden: tuple = (64, 64)

    def init(self, seed=0, device="cuda") -> dict:
        def build(gen):
            torso = MLPSpec(self.obs_dim, self.hidden)
            return {
                "pi": torso.build(gen),
                "vf": torso.build(gen),
                "pi_head": {"w": _dense_init(
                    gen, (self.hidden[-1], self.num_actions), 0.01),
                    "b": torch.zeros(self.num_actions)},
                "vf_head": {"w": _dense_init(gen, (self.hidden[-1], 1), 1.0),
                            "b": torch.zeros(1)},
            }
        return _init_tree(build, seed, device)

    def forward(self, params, obs):
        """-> (logits, value)."""
        obs = _as_input(obs, params["pi_head"]["w"])
        torso = MLPSpec(self.obs_dim, self.hidden)
        hp = torso.apply(params["pi"], obs)
        hv = torso.apply(params["vf"], obs)
        logits = hp @ params["pi_head"]["w"] + params["pi_head"]["b"]
        value = (hv @ params["vf_head"]["w"] + params["vf_head"]["b"])[..., 0]
        return logits, value


@dataclass
class QModule:
    """Q-network for DQN (online and target trees share the spec)."""

    obs_dim: int
    num_actions: int
    hidden: tuple = (64, 64)
    dueling: bool = True

    def init(self, seed=0, device="cuda") -> dict:
        def build(gen):
            p = {"torso": MLPSpec(self.obs_dim, self.hidden).build(gen),
                 "adv": {"w": _dense_init(
                     gen, (self.hidden[-1], self.num_actions)),
                     "b": torch.zeros(self.num_actions)}}
            if self.dueling:
                p["val"] = {"w": _dense_init(gen, (self.hidden[-1], 1)),
                            "b": torch.zeros(1)}
            return p
        return _init_tree(build, seed, device)

    def forward(self, params, obs):
        obs = _as_input(obs, params["adv"]["w"])
        h = MLPSpec(self.obs_dim, self.hidden).apply(params["torso"], obs)
        adv = h @ params["adv"]["w"] + params["adv"]["b"]
        if self.dueling:
            val = h @ params["val"]["w"] + params["val"]["b"]
            return val + adv - adv.mean(dim=-1, keepdim=True)
        return adv

    def forward_train(self, params, obs):
        return self.forward(params, obs)

    def forward_inference(self, params, obs):
        return torch.argmax(self.forward(params, obs), dim=-1)

    def forward_exploration(self, params, obs, generator, tau: float = 1.0):
        """Boltzmann exploration over Q values."""
        q = self.forward(params, obs)
        action, logp = _categorical(q / tau, generator)
        return action, logp, q.max(dim=-1).values


@dataclass
class SquashedGaussianModule:
    """Tanh-squashed Gaussian policy and twin Q critics for continuous
    control (the SAC module). Actions live in [low, high] by tanh
    rescaling; log-probs carry the tanh change of variables."""

    obs_dim: int
    action_dim: int
    low: tuple
    high: tuple
    hidden: tuple = (64, 64)

    action_kind = "continuous"
    LOG_STD_MIN = -10.0
    LOG_STD_MAX = 2.0

    def _scale(self, like):
        low = torch.tensor(self.low, dtype=torch.float32, device=like.device)
        high = torch.tensor(self.high, dtype=torch.float32,
                            device=like.device)
        return (high - low) / 2.0, (high + low) / 2.0

    def init(self, seed=0, device="cuda") -> dict:
        def build(gen):
            torso = MLPSpec(self.obs_dim, self.hidden, activation="relu")
            qspec = MLPSpec(self.obs_dim + self.action_dim, self.hidden,
                            activation="relu")
            out = {"pi": torso.build(gen),
                   "pi_head": {"w": _dense_init(
                       gen, (self.hidden[-1], 2 * self.action_dim), 0.01),
                       "b": torch.zeros(2 * self.action_dim)}}
            for q in ("q1", "q2"):
                out[q] = qspec.build(gen)
                out[q + "_head"] = {"w": _dense_init(
                    gen, (self.hidden[-1], 1)), "b": torch.zeros(1)}
            return out
        return _init_tree(build, seed, device)

    def pi(self, params, obs):
        obs = _as_input(obs, params["pi_head"]["w"])
        torso = MLPSpec(self.obs_dim, self.hidden, activation="relu")
        h = torso.apply(params["pi"], obs)
        out = h @ params["pi_head"]["w"] + params["pi_head"]["b"]
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, self.LOG_STD_MIN, self.LOG_STD_MAX)

    @staticmethod
    def _tanh_logdet(pre_tanh):
        # log|d tanh / dx| = 2 (log 2 - x - softplus(-2x)), stable
        return (2 * (math.log(2.0) - pre_tanh
                     - F.softplus(-2 * pre_tanh))).sum(-1)

    def sample(self, params, obs, generator):
        """Reparameterized sample -> (action in env bounds, logp)."""
        mean, log_std = self.pi(params, obs)
        std = torch.exp(log_std)
        eps = torch.randn(mean.shape, generator=generator,
                          device=mean.device)
        pre_tanh = mean + std * eps
        logp = (-0.5 * eps ** 2 - log_std
                - 0.5 * math.log(2 * math.pi)).sum(-1)
        logp = logp - self._tanh_logdet(pre_tanh)
        scale, shift = self._scale(mean)
        logp = logp - torch.log(scale).sum()
        return torch.tanh(pre_tanh) * scale + shift, logp

    def log_prob(self, params, obs, action):
        """log pi(action | obs) for env-bounded actions (the inverse of
        `sample`'s squash and rescale)."""
        mean, log_std = self.pi(params, obs)
        scale, shift = self._scale(mean)
        action = _as_input(action, mean)
        tanh_a = torch.clamp((action - shift) / scale, -0.999999, 0.999999)
        pre_tanh = torch.atanh(tanh_a)
        std = torch.exp(log_std)
        logp = (-0.5 * torch.square((pre_tanh - mean) / std) - log_std
                - 0.5 * math.log(2 * math.pi)).sum(-1)
        logp = logp - self._tanh_logdet(pre_tanh)
        return logp - torch.log(scale).sum()

    def q_values(self, params, obs, action):
        obs = _as_input(obs, params["q1_head"]["w"])
        action = _as_input(action, obs)
        qspec = MLPSpec(self.obs_dim + self.action_dim, self.hidden,
                        activation="relu")
        x = torch.cat([obs, action], dim=-1)
        h1 = qspec.apply(params["q1"], x)
        h2 = qspec.apply(params["q2"], x)
        q1 = (h1 @ params["q1_head"]["w"] + params["q1_head"]["b"])[..., 0]
        q2 = (h2 @ params["q2_head"]["w"] + params["q2_head"]["b"])[..., 0]
        return q1, q2

    def forward_exploration(self, params, obs, generator):
        action, logp = self.sample(params, obs, generator)
        return action, logp, torch.zeros(action.shape[0],
                                         device=action.device)

    def forward_inference(self, params, obs):
        mean, _ = self.pi(params, obs)
        scale, shift = self._scale(mean)
        return torch.tanh(mean) * scale + shift


@dataclass
class ConvSpec:
    """Conv torso for image observations. The parameters keep the
    reference's layouts (HWIO kernels, a dense layer reading the flatten
    in (h, w, c) order) and VALID padding; the input is NHWC, flat
    [..., H*W*C] (the runner's layout) or with any leading batch dims
    ([B, ...] or IMPALA's [T, B, ...]). The convolutions run NCHW with
    OIHW kernels (permuted at use), and the output goes back to NHWC
    before the flatten."""

    obs_shape: tuple  # (H, W, C)
    filters: tuple    # ((out_channels, kernel, stride), ...)
    dense: int = 128

    def build(self, gen) -> list:
        params = []
        c_in = self.obs_shape[-1]
        h, w = self.obs_shape[0], self.obs_shape[1]
        for out_c, k, s in self.filters:
            fan_in = k * k * c_in
            params.append({"w": _uniform(gen, (k, k, c_in, out_c),
                                         1.0 / math.sqrt(fan_in)),
                           "b": torch.zeros(out_c)})
            h = (h - k) // s + 1
            w = (w - k) // s + 1
            c_in = out_c
        params.append({"w": _dense_init(gen, (h * w * c_in, self.dense)),
                       "b": torch.zeros(self.dense)})
        return params

    def apply(self, params, x):
        shape = tuple(self.obs_shape)
        if tuple(x.shape[-len(shape):]) == shape:
            lead = x.shape[:-len(shape)]
        else:
            lead = x.shape[:-1]  # flat [..., H*W*C]
        x = x.reshape((-1,) + shape).permute(0, 3, 1, 2)
        for (_out_c, _k, s), layer in zip(self.filters, params[:-1]):
            x = torch.relu(F.conv2d(x, layer["w"].permute(3, 2, 0, 1),
                                    layer["b"], stride=s))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        head = params[-1]
        out = torch.relu(x @ head["w"] + head["b"])
        return out.reshape(tuple(lead) + (self.dense,))


# Standard conv stacks: the small net for 10x10 MinAtar-class grids, the
# nature-CNN for 84x84 Atari frames (parity: rllib catalog defaults).
MINATAR_FILTERS = ((16, 3, 1),)
NATURE_FILTERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


@dataclass
class CNNActorCriticModule(_DiscreteActor):
    """Policy and value heads over a shared conv torso, for image obs."""

    obs_shape: tuple
    num_actions: int
    filters: tuple = MINATAR_FILTERS
    dense: int = 128

    def _torso(self):
        return ConvSpec(self.obs_shape, self.filters, self.dense)

    def init(self, seed=0, device="cuda") -> dict:
        def build(gen):
            return {
                "torso": self._torso().build(gen),
                "pi_head": {"w": _dense_init(
                    gen, (self.dense, self.num_actions), 0.01),
                    "b": torch.zeros(self.num_actions)},
                "vf_head": {"w": _dense_init(gen, (self.dense, 1), 1.0),
                            "b": torch.zeros(1)},
            }
        return _init_tree(build, seed, device)

    def forward(self, params, obs):
        """-> (logits, value)."""
        obs = _as_input(obs, params["pi_head"]["w"])
        h = self._torso().apply(params["torso"], obs)
        logits = h @ params["pi_head"]["w"] + params["pi_head"]["b"]
        value = (h @ params["vf_head"]["w"] + params["vf_head"]["b"])[..., 0]
        return logits, value


def _is_box(space) -> bool:
    return type(space).__name__ == "Box"


def module_for_env(env_like, hidden=(64, 64), kind="actor_critic"):
    """The default module for an env's (observation_space, action_space):
    the port's spaces or gymnasium's. Box action spaces get the
    squashed-Gaussian module (SAC), image obs the conv module."""
    obs_dim = int(np.prod(env_like.observation_space.shape))
    space = env_like.action_space
    if _is_box(space):
        if kind != "sac":
            raise ValueError(
                f"only SAC supports continuous (Box) action spaces so far; "
                f"{kind!r} modules need a Discrete space (got {space})")
        low = np.asarray(space.low, np.float32).ravel()
        high = np.asarray(space.high, np.float32).ravel()
        if not (np.isfinite(low).all() and np.isfinite(high).all()):
            raise ValueError(
                f"continuous control needs bounded actions; got Box with "
                f"low={space.low}, high={space.high}")
        return SquashedGaussianModule(
            obs_dim, int(np.prod(space.shape)),
            tuple(low.tolist()), tuple(high.tolist()), hidden)
    num_actions = int(space.n)
    obs_shape = tuple(env_like.observation_space.shape)
    if kind == "actor_critic" and len(obs_shape) == 3 and obs_shape[0] >= 8:
        # Image observations get the conv module: the small net for
        # MinAtar-class grids, the nature-CNN for Atari-sized frames.
        filters, dense = ((NATURE_FILTERS, 512) if obs_shape[0] >= 64
                          else (MINATAR_FILTERS, 128))
        return CNNActorCriticModule(obs_shape, num_actions,
                                    filters=filters, dense=dense)
    if kind == "q":
        return QModule(obs_dim, num_actions, hidden)
    return ActorCriticModule(obs_dim, num_actions, hidden)
