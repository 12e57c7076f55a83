"""Port of :mod:`repro.launch`: the LM serving CLI (``serve``)."""
