"""Entry points of the port's model path: the prefill and serve steps and
the serving driver (counterpart of :mod:`repro.launch`)."""
