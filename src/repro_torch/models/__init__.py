"""Model zoo of the port: the paper's models (``mlp``: the DNN/MLR;
``resnet``; ``mf``; ``vae``; ``lda``), the dense and MoE decoder
transformers (``layers``, ``transformer``, ``moe``), the Mamba2 SSD blocks
and pure-SSM LM (``ssm``), the mamba + shared-attention hybrid
(``hybrid``) and the Whisper-style encoder-decoder (``encdec``; the VLM's
periodic cross-attention lives in ``transformer``)."""
