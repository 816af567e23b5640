"""Model zoo of the port: the paper's models (``mlp``: the DNN/MLR;
``resnet``; ``mf``; ``vae``; ``lda``) and the dense and MoE decoder
transformers (``layers``, ``transformer``, ``moe``). The SSM, hybrid,
encoder-decoder and vision families follow in ROADMAP A.10."""
