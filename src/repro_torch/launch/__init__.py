"""Port of :mod:`repro.launch`: the LM training CLI (``train``), the LM
serving CLI (``serve``) and the SNN serving CLI (``serve_snn``, the port
of ``examples/serve_snn.py``)."""
