from .pipeline import (ByteTokenizer, PackedStream, make_train_batches,
                       synthetic_documents)

__all__ = ["ByteTokenizer", "PackedStream", "make_train_batches",
           "synthetic_documents"]
