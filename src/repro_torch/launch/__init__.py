"""Port of :mod:`repro.launch`: the mesh builders (``mesh``), the
per-cell strategies (``strategy``) and the stand-ins of every leaf
(``specs``), the LM training CLI (``train``), the LM serving CLI
(``serve``) and the SNN serving CLI (``serve_snn``, the port of
``examples/serve_snn.py``). The dry run and its compiled-program
analysis (``dryrun``, ``hlo_analysis``) are ROADMAP Queue A item 9b."""
