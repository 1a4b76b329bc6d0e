"""Row-group algebra: order-domain comparison, the sorting buffer, schema
conversion, the ordered merge and the sorting writer, and the predicate
trees the scan planner evaluates."""
from .buffer import SortingColumn, TableBuffer, permute_column
from .compare import compare_func_of, min_max, normalize, sort_key
from .convert import can_convert, column_to_data, convert_table, convert_values
from .merge import iter_merged, merge_files, merge_row_groups
from .sorting import SortingWriter
