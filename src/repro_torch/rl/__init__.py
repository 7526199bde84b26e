from repro_torch.rl.async_is import async_is_loss, calibration_mask, staleness_keep  # noqa: F401
from repro_torch.rl.distill import onpolicy_distill_loss  # noqa: F401
from repro_torch.rl.grpo import group_advantages, grpo_icepop_loss, pop_mask  # noqa: F401
