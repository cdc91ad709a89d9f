from .config import (default_config, load_config, parse_config, parse_dir,
                     patch_config, write_config)

__all__ = ["default_config", "load_config", "parse_config", "parse_dir",
           "patch_config", "write_config"]
