"""The agent contract the in-pod runtime reads: env names and alloc-dir
subdirectories, copied from ``elastic_tpu_agent/common.py``.

The node agent writes and reads these exact spellings (the alloc-spec env,
``ack/<hash>.json``, ``usage/`` and ``flight/``), whatever accelerator the
pod holds, so the port keeps them unchanged: a GPU pod speaks the same
handshake as a TPU one. The port imports nothing of the JAX package, so it
carries this copy; ``tests/test_torch_runtime.py`` pins every value equal
to ``common.py``'s.
"""

# Slice generation counter: bumped when the slice re-forms at a new world
# size, which signals checkpoint-restore.
EnvSliceEpoch = "ELASTIC_TPU_SLICE_EPOCH"

# Drain stamp (trigger) and its hard wall-clock deadline (unix seconds).
EnvDrain = "ELASTIC_TPU_DRAIN"
EnvDrainDeadline = "ELASTIC_TPU_DRAIN_DEADLINE"

# QoS throttle: the reason and the deadline past which the binding goes.
EnvThrottle = "ELASTIC_TPU_THROTTLE"
EnvThrottleDeadline = "ELASTIC_TPU_THROTTLE_DEADLINE"

# Alloc-dir subdirectories: self-reported utilization, checkpoint acks and
# flight-recorder summaries, each keyed by the allocation hash.
UsageReportSubdir = "usage"
AckSubdir = "ack"
FlightSummarySubdir = "flight"

# Restore stamp a destination agent writes for a replacement pod.
EnvRestoreDir = "ELASTIC_TPU_RESTORE_DIR"
EnvRestoreStep = "ELASTIC_TPU_RESTORE_STEP"
EnvRestoreTrace = "ELASTIC_TPU_RESTORE_TRACE"

# Pre-copy cutover: the coordinator's stamp that ends a delta stream.
EnvCutover = "ELASTIC_TPU_CUTOVER"

# The allocation hash injected into the container ("GPU" is the legacy
# spelling the hook also accepts).
EnvAllocationHash = "TPU"
EnvAllocationHashCompat = "GPU"
