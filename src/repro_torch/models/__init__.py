"""Port of ``repro/models``: the language models of the ``ssm`` family
(RWKV-6, ``rwkv.py``) and the ``hybrid`` family (Zamba2: Mamba-2 layers
with one shared attention block, ``mamba2.py``), built from
``layers.py`` and driven by ``model.py`` (init, train/prefill/decode
forward). The other families are not ported yet (ROADMAP Queue A item
8)."""
