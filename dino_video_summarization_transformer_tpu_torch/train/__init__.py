from .dino import scoring_dino_loss

__all__ = ["scoring_dino_loss"]
