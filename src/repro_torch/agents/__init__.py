"""Agent context management and the synthetic search environment (port of
``repro.agents``; numpy host code)."""
from repro_torch.agents.context_mgmt import (DiscardAll,  # noqa: F401
                                             Hierarchical, KeepRecentK,
                                             NoManagement, Strategy,
                                             run_episode)
from repro_torch.agents.search_env import make_env, scripted_agent  # noqa: F401
