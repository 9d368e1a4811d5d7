from .scenes import cornell_box, material_ball, many_lights, sphere_field
