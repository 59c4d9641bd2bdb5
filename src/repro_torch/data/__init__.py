"""Data adapters of the port (counterpart of :mod:`repro.data`)."""
