# Domain datacubes and request populations (weather).
