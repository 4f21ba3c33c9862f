"""The port of :mod:`repro.distrib`: sharding rules as DTensor placements,
the tiered gradient sync on ``torch.distributed``, the ambient mesh
(:mod:`repro_torch.distrib.compat`) and the partitioned train step
(:mod:`repro_torch.distrib.partition`).  Importing it starts no process
group."""
from repro_torch.distrib.sharding import (MeshShape, batch_shardings,
                                          batch_spec, cache_shardings,
                                          cache_spec, dp_axes,
                                          opt_state_shardings,
                                          param_shardings, param_spec,
                                          replicated)
from repro_torch.distrib.tiered_sync import (TierAssignment, choose_tiers,
                                             dcn_bytes_per_step,
                                             tiered_grad_sync)

__all__ = ["batch_shardings", "batch_spec", "cache_shardings", "cache_spec",
           "dp_axes", "opt_state_shardings", "param_shardings", "param_spec",
           "replicated", "TierAssignment", "choose_tiers",
           "dcn_bytes_per_step", "tiered_grad_sync", "MeshShape"]
