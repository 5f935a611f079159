"""Communication codecs, per-run comm state, the adaptive per-client
codec controller and the streaming aggregation server side, ported from
``repro.fl.comm``."""
from repro_torch.fl.comm.adaptive import (RUNG_LADDER, AdaptiveCommController,
                                          RoundAssignment, is_adaptive_spec,
                                          ladder_between, parse_adaptive_spec)
from repro_torch.fl.comm.codecs import (CODECS, Codec, EncodedLeaf, Payload,
                                        available_codecs, make_codec)
from repro_torch.fl.comm.fused import aggregate_quantized, is_quantized
from repro_torch.fl.comm.state import CommState, fp32_nbytes
from repro_torch.fl.comm.stream import (PackedUpdate, StreamAccumulator,
                                        payload_family, weighted_model_sum,
                                        weighted_tree_sum)

__all__ = [
    "CODECS", "Codec", "EncodedLeaf", "Payload", "available_codecs",
    "make_codec", "CommState", "fp32_nbytes",
    "aggregate_quantized", "is_quantized",
    "PackedUpdate", "StreamAccumulator", "payload_family",
    "weighted_model_sum", "weighted_tree_sum",
    "RUNG_LADDER", "AdaptiveCommController", "RoundAssignment",
    "is_adaptive_spec", "ladder_between", "parse_adaptive_spec",
]
