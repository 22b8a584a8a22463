from .pipeline import pad_moving_plans, render_mixture_sources

__all__ = ["pad_moving_plans", "render_mixture_sources"]
