"""Port of :mod:`repro.snn`: LIF dynamics, the SFNN/SRNN models, BPTT
training (``train``) and quantization."""
from repro_torch.snn.lif import (LIFIntParams, LIFParams, alpha_to_shift,
                                 lif_step, lif_step_int, spike_fn)
from repro_torch.snn.models import (MNIST_CONFIG, SHD_CONFIG, SNNConfig,
                                    forward, init_params, masked_weights)
from repro_torch.snn.quantize import QuantConfig, QuantizedSNN, quantize

__all__ = ["LIFParams", "LIFIntParams", "lif_step", "lif_step_int",
           "alpha_to_shift", "spike_fn", "SNNConfig", "MNIST_CONFIG",
           "SHD_CONFIG", "init_params", "masked_weights", "forward",
           "QuantConfig", "QuantizedSNN", "quantize"]
