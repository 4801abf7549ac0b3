from .dadd import DADD, DADDCore, DADDCoreConfig, core_config_from
from .sampler import SamplerConfig, cfg_eps_fn, ddim_sample, dpm_sample
from .schedule import NoiseSchedule, ddim_timesteps

__all__ = [
    "DADD",
    "DADDCore",
    "DADDCoreConfig",
    "core_config_from",
    "SamplerConfig",
    "cfg_eps_fn",
    "ddim_sample",
    "dpm_sample",
    "NoiseSchedule",
    "ddim_timesteps",
]
