"""Log IO of the port (``graph_slam_tpu/io`` counterpart)."""

from .vro_log import FAILED_INFO_SENTINEL, VROLog, read_vro_log, write_vro_log

__all__ = ["VROLog", "read_vro_log", "write_vro_log", "FAILED_INFO_SENTINEL"]
