"""Deterministic synthetic data and the host data pipeline on the paper's
queue (PyTorch port of ``repro.data``)."""

from repro_torch.data.synthetic import SynthDataset, synth_batch
from repro_torch.data.pipeline import WorkStealingPipeline

__all__ = ["SynthDataset", "synth_batch", "WorkStealingPipeline"]
