from yolofastest_torch.native.engine import (NativeEngine, available_library, build_library,
                                             build_shlo_runner, default_library_path,
                                             find_library, find_shlo_runner, run_shlo)

__all__ = ["NativeEngine", "available_library", "build_library", "build_shlo_runner",
           "default_library_path", "find_library", "find_shlo_runner", "run_shlo"]
