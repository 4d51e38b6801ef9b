"""`recon`-compatible command line entry point.

Usage: python -m meshrecon.cli [OPTIONS] [INPUT_FILE]  (see pipeline/config.py
for the full flag surface, which mirrors configuration.cpp:109-123).
"""

from __future__ import annotations

import sys


def main(argv=None):
    from meshrecon.pipeline.config import apply_kernel_knobs, configs_from_args
    from meshrecon.pipeline.reconstruct import reconstruct, reconstruct_scenes
    from meshrecon.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    configs = configs_from_args(argv)
    apply_kernel_knobs(configs[0])
    configs[0].log(2, " Loaded configuration and video clip")

    def run():
        if len(configs) == 1:
            reconstruct(configs[0])
        else:
            reconstruct_scenes(configs,
                               scene_devices=configs[0].scene_devices)

    if configs[0].profile_dir:
        from meshrecon.utils.profiling import profile_trace

        with profile_trace(configs[0].profile_dir):
            run()
    else:
        run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
