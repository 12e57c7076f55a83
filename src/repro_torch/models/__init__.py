"""Port of ``repro/models``: the language models of the ``ssm`` family
(RWKV-6, ``rwkv.py``), the ``hybrid`` family (Zamba2: Mamba-2 layers
with one shared attention block, ``mamba2.py``) and the ``dense`` GQA
transformers, built from ``layers.py`` and driven by ``model.py`` (init,
train/prefill/decode forward, the chunked loss). The other families are
not ported yet (ROADMAP Queue A item 8)."""
