"""Port of :mod:`repro.snn`: the integer LIF neuron (``lif``)."""
