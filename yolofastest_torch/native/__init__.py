from yolofastest_torch.native.engine import (NativeEngine, available_library, build_library,
                                             default_library_path, find_library)

__all__ = ["NativeEngine", "available_library", "build_library", "default_library_path",
           "find_library"]
