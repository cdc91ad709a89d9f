"""Flagship workload: the rexrov2 AUV and its depth-setpoint task.

The vehicle table is a Python literal of the JAX package's bundled YAML
(``mppi_tf_tpu/cfg/defaults/models/rexrov2.yaml``; reference:
config/models/rexrov2.default.yaml), so that this package needs no YAML
parser. A test holds the two equal.
"""

import copy

import numpy as np

_REXROV2 = {
    "type": "auv",
    "model": "rexrov2",
    "mass": 1862.87,
    "volume": 1.8121303501945525,
    "density": 1028.0,
    "cog": [0.0, 0.0, 0.0],
    "cob": [0.0, 0.0, 0.3],
    "Ma": [
        [779.79, -6.8773, -103.32, 8.5426, -165.54, -7.8033],
        [-6.8773, 1222.0, 51.29, 409.44, -5.8488, 62.726],
        [-103.32, 51.29, 3659.9, 6.1112, -386.42, 10.774],
        [8.5426, 409.44, 6.1112, 534.9, -10.027, 21.019],
        [-165.54, -5.8488, -386.42, -10.027, 842.69, -1.1162],
        [-7.8033, 62.726, 10.775, 21.019, -1.1162, 224.32],
    ],
    "linear_damping": [-74.82, -69.48, -728.4, -268.8, -309.77, -105.0],
    "quad_damping": [-748.22, -992.53, -1821.01, -672.0, -774.44, -523.27],
    "linear_damping_forward_speed": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "inertial": {"ixx": 525.39, "iyy": 794.2, "izz": 691.23, "ixy": 1.44,
                 "ixz": 33.41, "iyz": 2.6},
    "rk": 2,
    "limMax": 500,
    "limMin": -500,
}


def auv_params() -> dict:
    """rexrov2 vehicle parameters (a fresh copy on every call)."""
    return copy.deepcopy(_REXROV2)


def auv_task() -> dict:
    """Depth-setpoint quaternion task (the flagship target): z = -5, qw = 1."""
    goal = np.zeros(13)
    goal[2] = -5.0
    goal[6] = 1.0
    return {
        "type": "static_quat",
        "diag": True,
        "goal": goal.tolist(),
        "Q": [100.0, 100.0, 100.0, 10.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
    }
