"""Physics-grade crossbar models: the exact nodal wire model and device
dynamics, as in `repro/physics`.

`nodal`    - batched block-tridiagonal MNA solve (the exact wire model);
             its sweeps run in the hand-written CUDA kernel on the card
`dynamics` - retention drift and write-verify programming loops
`faults`   - stuck-at injection with fault-aware row/column remapping

They plug into `NonidealConfig` through `core/nonideal.py`
(`wire_model="nodal"`, nodal write-verify, `p_stuck_on/off`), so every
executor and the serving layer use them unchanged.
"""
from repro_torch.physics.dynamics import drift_conductance, write_verify
from repro_torch.physics.faults import (apply_stuck_faults,
                                        fault_aware_permutations,
                                        sample_stuck_masks)
from repro_torch.physics.nodal import (nodal_effective_conductance,
                                       nodal_effective_conductance_batched,
                                       nodal_inv_batched, nodal_inv_outputs,
                                       nodal_mvm_batched, nodal_mvm_currents,
                                       row_schur_blocks)

__all__ = [
    "drift_conductance", "write_verify",
    "apply_stuck_faults", "fault_aware_permutations", "sample_stuck_masks",
    "nodal_effective_conductance", "nodal_effective_conductance_batched",
    "nodal_inv_batched", "nodal_inv_outputs",
    "nodal_mvm_batched", "nodal_mvm_currents", "row_schur_blocks",
]
