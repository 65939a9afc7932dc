"""Stage-3/4 communication over ``torch.distributed`` (see
:mod:`repro_torch.comm.comm` and :mod:`repro_torch.comm.stage4`)."""

from repro_torch.comm.comm import (CommConfig, FactorReducer, STRATEGIES,
                                   WIRE_DTYPES, gather_stat_bytes,
                                   hier_split, make_comm_config,
                                   template_gather_bytes,
                                   template_wire_bytes,
                                   template_wire_level_bytes,
                                   wire_stat_bytes, wire_stat_level_bytes)
from repro_torch.comm.stage4 import Stage4Inverter

__all__ = ["CommConfig", "FactorReducer", "STRATEGIES", "Stage4Inverter",
           "WIRE_DTYPES", "gather_stat_bytes", "hier_split",
           "make_comm_config", "template_gather_bytes",
           "template_wire_bytes", "template_wire_level_bytes",
           "wire_stat_bytes", "wire_stat_level_bytes"]
