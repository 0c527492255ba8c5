"""LM models of the port, after ``repro.models``: shared components
(``common.py``), the dense/MoE/VLM trunk (``dense.py``, ``moe.py``), the
Mamba2 and xLSTM blocks (``ssm.py``, ``xlstm.py``), the recurrent LMs
(``recurrent_lm.py``: XLSTM, Zamba2), the encoder-decoder (``encdec.py``:
Whisper) and the family API (``api.py``).  Plain PyTorch: the reference
computes these outside any Pallas kernel."""
