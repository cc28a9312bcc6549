"""The host modules the port shares with the JAX package, imported as they are.

These modules are numpy-only: importing them loads no jax (checked by
tests/test_torch_imports.py). Every other piece of the JAX package that the
port needs is ported or copied into this package, because the rest of that
package imports jax at module load, and the machine with the card has none.
Importing the shared modules through this one file keeps that boundary in
one place.
"""

from adhoc_queries_pointclouds_tpu import index, native  # noqa: F401
from adhoc_queries_pointclouds_tpu.formats import (  # noqa: F401
    is_valid_file,
    open_point_cloud,
    synth,
)
from adhoc_queries_pointclouds_tpu.formats.las import (  # noqa: F401
    encode_point_records,
    has_gps_time,
    make_writeback_header,
    write_las_chunked,
)
from adhoc_queries_pointclouds_tpu.models.query import (  # noqa: F401
    BoundsQuery,
    ClassQuery,
    DensityConfig,
    QueryPlan,
    TimeRangeQuery,
)
from adhoc_queries_pointclouds_tpu.sinks import (  # noqa: F401
    FileHits,
    HitEmitter,
    gather_hits,
)
from adhoc_queries_pointclouds_tpu.utils.aabb import (  # noqa: F401
    AABB,
    clamp_bounds_to_i32,
    local_query_bounds,
    parse_aabb,
)
from adhoc_queries_pointclouds_tpu.utils.timing import (  # noqa: F401
    StageTimer,
    throughput_line,
)
