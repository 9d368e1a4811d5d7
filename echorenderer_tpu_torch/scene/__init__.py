from .entities import Entity, EntityPack, Scene, PackInstance
from .geometries import (
    BoxEntity,
    MeshEntity,
    PlaneEntity,
    SphereEntity,
    TriangleEntity,
)
from .materials import (
    CoatedDiffuse,
    Conductor,
    Dielectric,
    Diffuse,
    Emissive,
    Invisible,
    Material,
    OneSided,
)
from .cameras import Camera, CylindricalCamera, OrthographicCamera, PerspectiveCamera
from .lights import AmbientLight, DirectionalLight, PointLight
