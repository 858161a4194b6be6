from .model import (decode_step, encode, forward, group_layout, init_cache,
                    init_params)

__all__ = ["decode_step", "encode", "forward", "group_layout", "init_cache",
           "init_params"]
