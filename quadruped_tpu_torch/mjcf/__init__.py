from .model import Option, PhysicsModel
from .parser import compile_spec
from .spec import RawSpec
