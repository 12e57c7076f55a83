"""Port of :mod:`repro.launch`: the mesh builders (``mesh``), the
per-cell strategies (``strategy``) and the stand-ins of every leaf
(``specs``), the LM training CLI (``train``), the LM serving CLI
(``serve``), the SNN serving CLI (``serve_snn``, the port of
``examples/serve_snn.py``), and the dry run over the production meshes
(``dryrun``) with its per-device cost counter (``hlo_analysis``)."""
