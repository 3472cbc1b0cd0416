from .networks import MLP, ActorCritic  # noqa: F401
from .ppo import PPO, PPOConfig, PPOTrainState, Transition  # noqa: F401
from .running_stats import (  # noqa: F401
    RunningMeanStd,
    rms_denormalize,
    rms_normalize,
    rms_update,
)
