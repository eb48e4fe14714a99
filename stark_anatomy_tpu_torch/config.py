"""Frozen configuration objects and device selection for the port.

``StarkConfig`` and ``MeshConfig`` are the JAX package's
(stark_anatomy_tpu/config.py): the STARK parameters, and the (dp, sp)
layout that ``MeshConfig.build`` turns into a parallel/mesh.py:Mesh over
the real devices (raising with too few).  ``resolve_device`` is the one
place that turns a ``device=`` argument into a torch device: the port
runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class StarkConfig:
    """Parameters of a STARK instance (reference: stark.py:8-33)."""

    expansion_factor: int = 4
    num_colinearity_checks: int = 64
    security_level: int = 128
    num_registers: int = 2
    num_cycles: int = 28
    transition_constraints_degree: int = 3

    def __post_init__(self):
        assert self.expansion_factor & (self.expansion_factor - 1) == 0, (
            "expansion factor must be a power of 2"
        )
        assert self.expansion_factor >= 4, "expansion factor must be >= 4"
        assert 2 * self.num_colinearity_checks >= self.security_level, (
            "colinearity checks must cover half the security level"
        )

    # derived quantities (reference: stark.py:19-26)
    @property
    def num_randomizers(self) -> int:
        return 4 * self.num_colinearity_checks

    @property
    def randomized_trace_length(self) -> int:
        return self.num_cycles + self.num_randomizers

    @property
    def omicron_domain_length(self) -> int:
        return 1 << (
            self.randomized_trace_length * self.transition_constraints_degree
        ).bit_length()

    @property
    def fri_domain_length(self) -> int:
        return self.omicron_domain_length * self.expansion_factor


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism layout: dp = independent proofs, sp = codeword axis."""

    dp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.sp

    def build(self, devices=None):
        """A Mesh with these axes over the real devices (the CUDA cards, or
        the ranks under torch.distributed), or over ``devices`` when given
        (a virtual mesh); raises if there are fewer than ``num_devices``."""
        from .parallel.mesh import Mesh, make_mesh

        base = make_mesh(self.num_devices, devices=devices)
        if (base.shape["dp"], base.shape["sp"]) == (self.dp, self.sp):
            return base
        flat = [d for row in base.devices for d in row]
        return Mesh([flat[d * self.sp:(d + 1) * self.sp] for d in range(self.dp)], backend=base.backend)


RPSSS_CONFIG = StarkConfig()  # the production signature parameters


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises if there is none: the CPU
    is used only when the caller passes ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
