"""Models of the port: the paper's MLP (``mlp``) and the attention-only
family of ``repro.models`` (``config``, ``layers``, ``attention``,
``transformer``); the other group kinds are not ported yet."""
