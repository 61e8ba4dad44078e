"""Models of the port: the paper's MLP (``mlp``) and the model zoo of
``repro.models``: config-driven decoder transformers covering the ten
assigned architectures (dense GQA, sliding-window, GeGLU, MoE top-1,
mLSTM/sLSTM, Mamba2 hybrid, cross-attention VLM, audio-token decoders),
in ``config``, ``layers``, ``attention``, ``moe``, ``ssm`` and
``transformer``; ``parallel``, the model axis that splits a served model
over the ranks of a mesh's "model" dim."""
