"""Directory consensus, the engine, and the picker loops (the port of
``repic_tpu.pipeline``)."""

from repic_tpu_torch.pipeline.consensus import (
    ConsensusResult,
    consensus_one,
    make_batched_consensus,
    run_consensus_dir,
)

__all__ = [
    "ConsensusResult",
    "consensus_one",
    "make_batched_consensus",
    "run_consensus_dir",
]
