from repro_torch.roofline.analysis import (Roofline, active_param_count,
                                           analyze, collective_bytes,
                                           model_flops)

__all__ = ["Roofline", "analyze", "collective_bytes", "model_flops",
           "active_param_count"]
