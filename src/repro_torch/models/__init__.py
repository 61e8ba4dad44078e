"""Models of the port. So far the paper's MLP (``mlp``); the model zoo of
``repro.models`` is not ported yet."""
