"""Training (port of ``repro.train``): AdamW (``optimizer``), the train
step with microbatch accumulation (``trainer``), the straggler monitor,
``GracefulExit`` and ``run_supervised`` (``fault``) and the atomic
checkpoints that training and the runtime's snapshots ride
(``checkpoint``); ``launch/train.py`` drives them."""
