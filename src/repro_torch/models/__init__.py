"""Model zoo of the port: the paper's DNN/MLR (``mlp``) and the dense
decoder transformer (``layers``, ``transformer``). The other families
follow in ROADMAP A.4 and A.10."""
