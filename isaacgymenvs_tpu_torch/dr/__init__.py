from .param_generator import FullCovarianceParamGenerator, MixtureParamGenerator
from .randomize import DomainRandomizer, DRSpec

__all__ = ["DomainRandomizer", "DRSpec", "FullCovarianceParamGenerator", "MixtureParamGenerator"]
