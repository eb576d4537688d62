from .radam import (FusedRiemannianAdam, PlateauState, RiemannianAdam, plateau_init,
                    plateau_update)

__all__ = ["FusedRiemannianAdam", "PlateauState", "RiemannianAdam", "plateau_init",
           "plateau_update"]
