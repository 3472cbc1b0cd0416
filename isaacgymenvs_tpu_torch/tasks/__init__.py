"""Task registry: string -> VecTask subclass (the ported tasks)."""
from __future__ import annotations

from typing import Dict, Type

from ..envcore.vec_task import VecTask
from .ant import Ant
from .cartpole import Cartpole

task_map: Dict[str, Type[VecTask]] = {"Ant": Ant, "Cartpole": Cartpole}
