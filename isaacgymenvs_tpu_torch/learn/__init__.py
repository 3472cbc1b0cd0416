from .amp import AMPAgent, AMPTrainState, Discriminator  # noqa: F401
from .hrl import HRL, AMPLatentActor  # noqa: F401
from .networks import MLP, ActorCritic, CriticNet  # noqa: F401
from .ppo import PPO, PPOConfig, PPOTrainState, Transition  # noqa: F401
from .replay_buffer import ReplayBuffer  # noqa: F401
from .rnn import LSTMActorCritic, PPORecurrent  # noqa: F401
from .running_stats import (  # noqa: F401
    RunningMeanStd,
    rms_denormalize,
    rms_normalize,
    rms_update,
)
from .sac import SAC, SACConfig  # noqa: F401
