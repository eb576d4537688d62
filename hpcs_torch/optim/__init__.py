from .radam import PlateauState, RiemannianAdam, plateau_init, plateau_update

__all__ = ["PlateauState", "RiemannianAdam", "plateau_init", "plateau_update"]
