from .config import ArchConfig, ShapeConfig, SHAPES, smoke_shape
from .model import Model, make_model
