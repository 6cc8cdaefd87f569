"""Developer probes of the port, the counterparts of the JAX package's
``tools/probe_*.py`` that reach ``pl.pallas_call``.  Each runs on the card:

    python -m pyrecode_tpu_torch.tools.probe_phases          # P1: encode phase split
    python -m pyrecode_tpu_torch.tools.probe_decode_phases   # P2: decode phase split
    python -m pyrecode_tpu_torch.tools.probe_mosaic          # P3: eight lowering probes
    python -m pyrecode_tpu_torch.tools.probe_f32dot          # P4: f32 products, exactness
    python -m pyrecode_tpu_torch.tools.probe_butterfly       # P5: butterfly left-pack

``--device cpu`` runs the kernels' plain twins and measures no time.  Each
module's ``run(...)`` returns what its ``main`` prints (``result["lines"]``)
with the numbers behind it.
"""
