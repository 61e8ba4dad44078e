from repro_torch.optim.optimizers import OptState, adamw, global_norm, sgd

__all__ = ["sgd", "adamw", "OptState", "global_norm"]
