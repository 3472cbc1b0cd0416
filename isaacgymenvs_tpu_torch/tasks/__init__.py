"""Task registry: string -> VecTask subclass (the ported tasks)."""
from __future__ import annotations

from typing import Dict, Type

from ..envcore.vec_task import VecTask
from .allegro_hand import AllegroHand
from .allegro_hand_dextreme import AllegroHandDextremeADR, AllegroHandDextremeManualDR
from .allegro_kuka import AllegroKukaRegrasping, AllegroKukaReorientation, AllegroKukaThrow
from .allegro_kuka_two_arms import AllegroKukaTwoArmsRegrasping, AllegroKukaTwoArmsReorientation
from .ant import Ant
from .anymal import Anymal
from .anymal_terrain import AnymalTerrain
from .ball_balance import BallBalance
from .cartpole import Cartpole
from .factory_nut_bolt import FactoryTaskNutBoltPick, FactoryTaskNutBoltPlace, FactoryTaskNutBoltScrew
from .factory_templates import FactoryTaskGears, FactoryTaskInsertion
from .franka_cabinet import FrankaCabinet
from .franka_cube_stack import FrankaCubeStack
from .humanoid import Humanoid
from .humanoid_amp import HumanoidAMP
from .industreal_gears_insert import IndustRealTaskGearsInsert
from .industreal_pegs_insert import IndustRealTaskPegsInsert
from .ingenuity import Ingenuity
from .quadcopter import Quadcopter
from .shadow_hand import ShadowHand
from .trifinger import Trifinger


def _resolve_subtask(subtask_map, cfg, *args, **kwargs):
    name = (cfg.get("env") or {}).get("subtask") or "reorientation"
    if name not in subtask_map:
        raise ValueError(f"Unknown subtask={name} in {sorted(subtask_map)}")
    return subtask_map[name](cfg, *args, **kwargs)


def resolve_allegro_kuka(cfg, *args, **kwargs):
    """`task=AllegroKuka`: the class of cfg.env.subtask (reorientation,
    regrasping or throw; reorientation when empty)."""
    return _resolve_subtask(dict(reorientation=AllegroKukaReorientation, regrasping=AllegroKukaRegrasping,
                                 throw=AllegroKukaThrow), cfg, *args, **kwargs)


def resolve_allegro_kuka_two_arms(cfg, *args, **kwargs):
    """`task=AllegroKukaTwoArms`: the class of cfg.env.subtask
    (reorientation or regrasping; reorientation when empty)."""
    return _resolve_subtask(dict(reorientation=AllegroKukaTwoArmsReorientation,
                                 regrasping=AllegroKukaTwoArmsRegrasping), cfg, *args, **kwargs)


task_map: Dict[str, Type[VecTask]] = {
    "AllegroHand": AllegroHand,
    "AllegroHandDextremeADR": AllegroHandDextremeADR,
    "AllegroHandDextremeManualDR": AllegroHandDextremeManualDR,
    # the reference's short names of the two DeXtreme tasks
    "AllegroHandADR": AllegroHandDextremeADR,
    "AllegroHandManualDR": AllegroHandDextremeManualDR,
    # `task=AllegroKuka` and `task=AllegroKukaTwoArms` resolve the class from cfg.env.subtask
    "AllegroKuka": resolve_allegro_kuka,
    "AllegroKukaTwoArms": resolve_allegro_kuka_two_arms,
    "AllegroKukaReorientation": AllegroKukaReorientation,
    "AllegroKukaRegrasping": AllegroKukaRegrasping,
    "AllegroKukaThrow": AllegroKukaThrow,
    "AllegroKukaTwoArmsReorientation": AllegroKukaTwoArmsReorientation,
    "AllegroKukaTwoArmsRegrasping": AllegroKukaTwoArmsRegrasping,
    "Ant": Ant,
    "Anymal": Anymal,
    "AnymalTerrain": AnymalTerrain,
    "BallBalance": BallBalance,
    "Cartpole": Cartpole,
    "FactoryTaskGears": FactoryTaskGears,
    "FactoryTaskInsertion": FactoryTaskInsertion,
    "FactoryTaskNutBoltPick": FactoryTaskNutBoltPick,
    "FactoryTaskNutBoltPlace": FactoryTaskNutBoltPlace,
    "FactoryTaskNutBoltScrew": FactoryTaskNutBoltScrew,
    "FrankaCabinet": FrankaCabinet,
    "FrankaCubeStack": FrankaCubeStack,
    "Humanoid": Humanoid,
    "HumanoidAMP": HumanoidAMP,
    "IndustRealTaskGearsInsert": IndustRealTaskGearsInsert,
    "IndustRealTaskPegsInsert": IndustRealTaskPegsInsert,
    "Ingenuity": Ingenuity,
    "Quadcopter": Quadcopter,
    "ShadowHand": ShadowHand,
    "Trifinger": Trifinger,
}
