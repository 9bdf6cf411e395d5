"""The plain reference of a render: fields, rays, trace and shading in
plain PyTorch, importing nothing of the program."""
