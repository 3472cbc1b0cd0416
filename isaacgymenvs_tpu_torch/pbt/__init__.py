from .mutation import get_mutation_func, mutate  # noqa: F401
from .pbt import PbtManager  # noqa: F401
