"""Model zoo of the port: the paper's models (``mlp``: the DNN/MLR;
``resnet``; ``mf``; ``vae``; ``lda``), the dense and MoE decoder
transformers (``layers``, ``transformer``, ``moe``), the Mamba2 SSD blocks
and pure-SSM LM (``ssm``) and the mamba + shared-attention hybrid
(``hybrid``). The encoder-decoder and vision families follow in ROADMAP
A.10."""
