"""Model configurations as Python literals.

Same schema as the JAX package's ``cfg/models/*.yaml`` (a test holds each
literal equal to its YAML): the machine that runs the port has no YAML parser.
"""

# QUAN-YOLO11-OBB (quaternion backbone + oriented-box head),
# the JAX package's cfg/models/yolo11-obb-quan.yaml.
YOLO11_OBB_QUAN = {
    "nc": 80,
    "scales": {  # [depth, width, max_channels]
        "n": [0.50, 0.25, 1024],
        "s": [0.50, 0.50, 1024],
        "m": [0.50, 1.00, 512],
        "l": [1.00, 1.00, 512],
        "x": [1.00, 1.50, 512],
    },
    "backbone": [
        [-1, 1, "Conv", [64, 3, 2]],           # 0  P1/2
        [-1, 1, "Conv", [128, 3, 2]],          # 1  P2/4
        [-1, 2, "C3k2", [256, False, 0.25]],   # 2
        [-1, 1, "Conv", [256, 3, 2]],          # 3  P3/8
        [-1, 2, "C3k2", [512, False, 0.25]],   # 4
        [-1, 1, "Conv", [512, 3, 2]],          # 5  P4/16
        [-1, 2, "C3k2", [512, True]],          # 6
        [-1, 1, "Conv", [1024, 3, 2]],         # 7  P5/32
        [-1, 2, "C3k2", [1024, True]],         # 8
        [-1, 1, "QSPPF", [1024, 5]],           # 9
        [-1, 2, "QC2PSA", [1024]],             # 10
    ],
    "head": [
        [-1, 1, "QUpsample", [2, "nearest"]],  # 11
        [[-1, 6], 1, "Concat", [1]],           # 12 cat P4
        [-1, 2, "C3k2", [512, False]],         # 13
        [-1, 1, "QUpsample", [2, "nearest"]],  # 14
        [[-1, 4], 1, "Concat", [1]],           # 15 cat P3
        [-1, 2, "C3k2", [256, False]],         # 16 (P3/8-small)
        [-1, 1, "Conv", [256, 3, 2]],          # 17
        [[-1, 13], 1, "Concat", [1]],          # 18 cat P4
        [-1, 2, "C3k2", [512, False]],         # 19 (P4/16-medium)
        [-1, 1, "Conv", [512, 3, 2]],          # 20
        [[-1, 10], 1, "Concat", [1]],          # 21 cat P5
        [-1, 2, "C3k2", [1024, True]],         # 22 (P5/32-large)
        [[16, 19, 22], 1, "OBB", ["nc", 1]],   # 23
    ],
}

# QUAN-YOLO11 (quaternion backbone + axis-aligned Detect head),
# the JAX package's cfg/models/yolo11-quan.yaml: the OBB graph with a Detect head.
YOLO11_QUAN = {
    "nc": 80,
    "scales": YOLO11_OBB_QUAN["scales"],
    "backbone": YOLO11_OBB_QUAN["backbone"],
    "head": YOLO11_OBB_QUAN["head"][:-1] + [
        [[16, 19, 22], 1, "Detect", ["nc"]],   # 23
    ],
}

# QUAN-YOLO11-seg (Detect + Proto + mask coefficients), the JAX package's
# cfg/models/yolo11-seg-quan.yaml: the OBB graph with a Segment head.
YOLO11_SEG_QUAN = {
    "nc": 80,
    "scales": YOLO11_OBB_QUAN["scales"],
    "backbone": YOLO11_OBB_QUAN["backbone"],
    "head": YOLO11_OBB_QUAN["head"][:-1] + [
        [[16, 19, 22], 1, "Segment", ["nc", 32, 256]],  # 23
    ],
}

# QUAN-YOLO11-pose (Detect + keypoint branch), the JAX package's
# cfg/models/yolo11-pose-quan.yaml: the OBB graph with a Pose head, one class.
YOLO11_POSE_QUAN = {
    "nc": 1,
    "kpt_shape": [17, 3],
    "scales": YOLO11_OBB_QUAN["scales"],
    "backbone": YOLO11_OBB_QUAN["backbone"],
    "head": YOLO11_OBB_QUAN["head"][:-1] + [
        [[16, 19, 22], 1, "Pose", ["nc", [17, 3]]],  # 23
    ],
}

# QUAN-YOLO11-cls (quaternion backbone + the working Classify head), the JAX
# package's cfg/models/yolo11-cls-quan.yaml: no QSPPF, QC2PSA at layer 9.
YOLO11_CLS_QUAN = {
    "nc": 1000,
    "scales": YOLO11_OBB_QUAN["scales"],
    "backbone": YOLO11_OBB_QUAN["backbone"][:9] + [
        [-1, 2, "QC2PSA", [1024]],             # 9
    ],
    "head": [
        [-1, 1, "Classify", ["nc"]],           # 10
    ],
}

# base file name (scale letter removed) -> configuration
MODELS = {"yolo11-obb-quan.yaml": YOLO11_OBB_QUAN, "yolo11-quan.yaml": YOLO11_QUAN,
          "yolo11-seg-quan.yaml": YOLO11_SEG_QUAN, "yolo11-pose-quan.yaml": YOLO11_POSE_QUAN,
          "yolo11-cls-quan.yaml": YOLO11_CLS_QUAN}
