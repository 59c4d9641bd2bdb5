"""The LM substrate of the port, as far as serving the sorted-dispatch MoE
model needs it: configuration, layers, the MoE block, the transformer
blocks and the model wrapper (counterpart of :mod:`repro.models`)."""
