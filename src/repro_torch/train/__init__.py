"""Training-side controls (port of ``repro.train``): the straggler monitor
the serving engine uses; the trainer waits for the training slice."""
