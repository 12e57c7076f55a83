"""Port of ``repro/models``: the language models of the ``ssm`` family
(RWKV-6, ``rwkv.py``), the ``hybrid`` family (Zamba2: Mamba-2 layers
with one shared attention block, ``mamba2.py``), the ``dense`` GQA
transformers, the ``moe`` family (routed experts, ``moe.py``; MLA in
``layers.py``), and the ``audio`` (codebooks, sinusoidal positions) and
``vlm`` (M-RoPE) backbones, built from ``layers.py`` and driven by
``model.py`` (init, train/prefill/decode forward, the chunked loss)."""
