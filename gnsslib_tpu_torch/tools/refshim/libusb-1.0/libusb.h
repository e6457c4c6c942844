/* stub: no USB hardware in the parity build (file front-end only) */
#ifndef LIBUSB_STUB_H
#define LIBUSB_STUB_H
#endif
