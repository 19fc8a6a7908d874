"""Host-side annotation drawing: corner-styled boxes, a name and similarity
caption, and a vertical similarity bar beside the box.

The port's own copy of the JAX package's ``utils/drawing.py``. cv2 is
imported inside each function: the card's machine has no cv2, and the
realtime app there takes another annotator.
"""
from __future__ import annotations


def draw_bbox(image, bbox, color=(0, 255, 0), thickness=3, proportion=0.2):
    import cv2

    x1, y1, x2, y2 = map(int, bbox[:4])
    corner = int(proportion * min(x2 - x1, y2 - y1))
    cv2.rectangle(image, (x1, y1), (x2, y2), color, 1)
    for (cx, cy, dx, dy) in ((x1, y1, 1, 1), (x2, y1, -1, 1),
                             (x1, y2, 1, -1), (x2, y2, -1, -1)):
        cv2.line(image, (cx, cy), (cx + dx * corner, cy), color, thickness)
        cv2.line(image, (cx, cy), (cx, cy + dy * corner), color, thickness)
    return image


def draw_bbox_info(frame, bbox, similarity, name, color):
    import cv2

    x1, y1, x2, y2 = map(int, bbox[:4])
    cv2.putText(frame, f"{name}: {similarity:.2f}", org=(x1, y1 - 10),
                fontFace=cv2.FONT_HERSHEY_COMPLEX_SMALL, fontScale=1,
                color=color, thickness=1)
    draw_bbox(frame, bbox, color)
    # the similarity bar to the right of the box, filled bottom-up
    bar_x0, bar_x1 = x2 + 10, x2 + 20
    bar_h = int(similarity * (y2 - y1))
    cv2.rectangle(frame, (bar_x0, y2 - bar_h), (bar_x1, y2), color, cv2.FILLED)
    return frame
