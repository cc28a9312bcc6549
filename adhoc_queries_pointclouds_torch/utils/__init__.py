from .aabb import AABB, parse_aabb, local_query_bounds  # noqa: F401
from .timing import StageTimer  # noqa: F401
