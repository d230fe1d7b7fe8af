"""Top-level ``internal_samplers`` module, as in the JAX package (and the
reference's ``dynesty.internal_samplers``): the proposal-kernel classes
and their registry list, from ``dynesty_tpu_torch.internal.samplers``."""

from .internal.samplers import (
    INTERNAL_SAMPLER_LIST,
    InternalSampler,
    UnitCubeSampler,
    UniformBoundSampler,
    RWalkSampler,
    SliceSampler,
    RSliceSampler,
)

__all__ = [
    "INTERNAL_SAMPLER_LIST",
    "InternalSampler",
    "UnitCubeSampler",
    "UniformBoundSampler",
    "RWalkSampler",
    "SliceSampler",
    "RSliceSampler",
]
