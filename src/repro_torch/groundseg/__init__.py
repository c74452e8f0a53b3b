"""Ground-segment subsystem: ground stations as FL aggregation sinks.

The paper's generic centralized FLA over real contact geometry: satellites
train locally, their parameter payloads ride store-and-forward multi-hop
ISL relays to ground sinks over the TDM slots of a contact plan, the sinks
FedAvg (optionally pooling over terrestrial backhaul), and the global model
floods back out on the downlink slots.

- :mod:`repro_torch.groundseg.routing` (numpy only) -- earliest-delivery
  contact-graph router, the static uplink relay and downlink broadcast
  programs, their batching, and the multi-window pipelined router.
- :mod:`repro_torch.groundseg.aggregation` -- the programs run on fused
  flat buffers stacked over the node axis: one row gather per batch per
  buffer (int8 through the ``tdm_compress`` CUDA kernels), all-node
  reductions for the shared scales and the sink pool.

Drivers live in :func:`repro_torch.launch.fl_train.run_groundseg_fl`; the
cost oracle in :func:`repro_torch.constellation.cost.groundseg_round_cost`.
"""

from repro_torch.groundseg import aggregation, routing

__all__ = ["aggregation", "routing"]
