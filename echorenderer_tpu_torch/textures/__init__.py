from .grids import (
    CLAMP,
    REPEAT,
    MIRROR,
    FILTER_BILINEAR,
    FILTER_POINT,
    ArrayGrid,
    CacheableTexture,
    GradientTexture,
    ImportGrid,
    PreparedGrid,
    Pure,
    Texture,
    TextureGrid,
)
from .procedural import CloudTexture, Gradient, fbm_noise, simplex_noise
from .directional import (
    ColorfulDirectionalTexture,
    Cubemap,
    CylindricalTexture,
    PreparedDirectional,
)

__all__ = [
    "CLAMP", "REPEAT", "MIRROR", "FILTER_BILINEAR", "FILTER_POINT",
    "ArrayGrid", "CacheableTexture", "GradientTexture", "ImportGrid",
    "PreparedGrid", "Pure", "Texture", "TextureGrid",
    "CloudTexture", "Gradient", "fbm_noise", "simplex_noise",
    "ColorfulDirectionalTexture", "Cubemap", "CylindricalTexture",
    "PreparedDirectional",
]
