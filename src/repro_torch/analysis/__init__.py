"""Port of :mod:`repro.analysis`: the range facts ``pack_dense`` needs."""
