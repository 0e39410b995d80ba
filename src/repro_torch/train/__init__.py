"""Training-side controls (port of ``repro.train``): the straggler
monitor, ``GracefulExit`` and ``run_supervised`` (``fault``) and the
atomic checkpoints the runtime's snapshots ride (``checkpoint``); the
trainer waits for the training slice."""
