from .model import Option, PhysicsModel
from .parser import (
    compile_spec,
    load_mjcf,
    load_mjcf_string,
    parse,
    parse_file,
    parse_raw,
    parse_string,
)
from .spec import RawSpec
