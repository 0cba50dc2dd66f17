"""The port's evaluation entry points, each runnable as ``python -m
fccf_pcr_torch.evaluation.<name>`` (``--device cuda`` by default, which
needs a CUDA card; ``--device cpu`` runs the kernels' plain versions):

  configs          the scene configurations and accuracy gates, shared
                   seed-to-scene assignment (a copy of ``bench.py``'s)
  evaluate         the accuracy sweep: success, RRE/RTE, flagged seeds,
                   pairs/s per configuration, with capacity escalation
  overlap_eval     success against partial overlap (office, resso)
  twin_production  the pipeline against the NumPy twin's cached
                   transforms at production density (``--check``), and
                   the twin's rows on those pairs (``--generate --out``)
  anchor_sensitivity  the twin under origin- and bbox-anchored octrees:
                   face membership, transforms and success
  measure_content  per-stage content maxima at generous capacities, the
                   numbers capacity presets are sized from
"""
