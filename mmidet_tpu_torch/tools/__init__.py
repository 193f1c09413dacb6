"""Ports of the JAX package's TPU probes under ``tools/``: each probe's
function as a hand-written CUDA kernel beside its plain PyTorch version,
with an entry point that checks and times it on the card
(``python -m mmidet_tpu_torch.tools.<probe>``)."""
