from .model import (decode_step, encode, forward, group_layout, init_cache,
                    init_params, local_text_rows, run_groups)

__all__ = ["decode_step", "encode", "forward", "group_layout", "init_cache",
           "init_params", "local_text_rows", "run_groups"]
