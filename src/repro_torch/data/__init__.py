"""Data adapters of the port (counterpart of :mod:`repro.data`)."""
from repro_torch.data.pipeline import DataLoader, SyntheticCorpus, dedup_examples, pack_by_length

__all__ = ["SyntheticCorpus", "DataLoader", "dedup_examples", "pack_by_length"]
