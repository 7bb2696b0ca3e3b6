"""Interactive 3D views of Data and NAG objects."""
from .visualization import Figure3D, class_palette, visualize_3d
