from .scoring import (FrameScorer, ScorerConfig, export_loss, make_scorers,
                      run_scoring)

__all__ = ["FrameScorer", "ScorerConfig", "export_loss", "make_scorers",
           "run_scoring"]
