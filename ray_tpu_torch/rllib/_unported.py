"""The names of the JAX package's RLlib that the port has not taken yet
(ROADMAP queue 1, item 10 (b)): asking a package for one raises
`NotImplementedError` instead of an `AttributeError`."""

from __future__ import annotations

ITEM_10B = {
    "DQN", "DQNConfig", "SAC", "SACConfig", "CQL", "CQLConfig", "BC",
    "BCConfig", "MARWIL", "MARWILConfig", "DreamerV3", "DreamerV3Config",
    "MultiAgentPPO", "MultiAgentPPOConfig", "MultiAgentEnv",
    "MultiAgentEnvRunner", "ReplayBuffer",
}


def module_getattr(module: str, names: set):
    """A module `__getattr__` raising NotImplementedError for `names`."""

    def __getattr__(name):
        if name in names:
            raise NotImplementedError(
                f"{module}.{name} is not ported yet: the off-policy, offline, "
                f"multi-agent and model-based half of RLlib is ROADMAP queue "
                f"1 item 10 (b)")
        raise AttributeError(f"module {module!r} has no attribute {name!r}")
    return __getattr__
