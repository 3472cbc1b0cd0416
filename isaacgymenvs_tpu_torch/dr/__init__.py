from .adr import ADR, AdrParamSpec, AdrState
from .param_generator import FullCovarianceParamGenerator, MixtureParamGenerator
from .randomize import DomainRandomizer, DRSpec

__all__ = ["ADR", "AdrParamSpec", "AdrState", "DomainRandomizer", "DRSpec", "FullCovarianceParamGenerator",
           "MixtureParamGenerator"]
