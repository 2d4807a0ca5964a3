from .optimizers import (Optimizer, adam, adamw, constant_schedule,
                         cosine_schedule, fedprox_loss, sgd)

__all__ = ["Optimizer", "adam", "adamw", "sgd", "fedprox_loss",
           "cosine_schedule", "constant_schedule"]
