from .query import BoundsQuery, ClassQuery, DensityConfig, QueryPlan  # noqa: F401
